"""Training loop, optimizer, data and metrics of the port."""
