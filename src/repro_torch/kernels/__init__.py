"""Hand-written CUDA kernels of the port, their plain PyTorch versions and
the host code around them."""
