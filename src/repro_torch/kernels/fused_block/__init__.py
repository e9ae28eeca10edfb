"""The fused-block kernel generator: one Triton kernel per WSP block."""
