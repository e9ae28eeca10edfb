"""The selective SSM scan (kernel B5): plain version, CUDA kernel and
public op, and the ``mamba_scan`` lowering claimant's op-pattern matcher
(``block.match``)."""
