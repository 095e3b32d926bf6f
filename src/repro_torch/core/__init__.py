"""Federated core of the port: sampling, masking, client update, codecs,
rounds, strategies and the server."""
