"""Hand-written Hopper kernels of the ISLA tick (CUDA C++ in ``csrc/``),
their ctypes binding and wrappers (``isla_moments``), the CPU/GPU dispatch
(``ops``) and their plain PyTorch versions (``ref``)."""
