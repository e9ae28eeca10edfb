"""The RWKV6 token recurrence (kernel B6): plain version, CUDA kernel and
public op."""
