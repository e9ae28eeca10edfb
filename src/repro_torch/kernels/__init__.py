"""Hand-written GPU kernels of the port (Triton and CUDA C++), one package
per kernel; ``cuda_build`` builds the CUDA sources of ``../csrc``."""
