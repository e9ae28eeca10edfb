"""Flash attention (kernel B3): plain version, CUDA kernel and public op,
and the ``flash_attention`` lowering claimant's op-pattern matcher
(``block.match``)."""
