"""The CEP join kernels: hand-written CUDA for Hopper (``window_join``),
their plain PyTorch versions (``ref``) and the dispatch (``ops``)."""
