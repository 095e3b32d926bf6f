"""Client models of the port (LeNet in this slice)."""
