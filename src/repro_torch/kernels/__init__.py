"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``, built by
``_build`` with nvcc for sm_90a and bound with ctypes).  Each kernel's
``ops.py`` holds its wrapper, its plain PyTorch version and its launch
counter; the plain version runs for CPU tensors only."""
