"""Hand-written CUDA kernels (sources in ``csrc/``), their build and their
PyTorch wrappers.  Importing this package builds and loads nothing."""
