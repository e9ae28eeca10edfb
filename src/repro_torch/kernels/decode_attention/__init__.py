"""Decode attention: the decode step's one-token attention over its KV
cache, read in place (CUDA kernel, plain version and custom op)."""
