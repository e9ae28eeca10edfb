"""Hand-written GPU kernels of the port (Triton), one package per kernel."""
