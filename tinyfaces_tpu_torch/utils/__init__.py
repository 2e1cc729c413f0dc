"""Host utilities of the port: weight bridge, CUDA build helper."""
