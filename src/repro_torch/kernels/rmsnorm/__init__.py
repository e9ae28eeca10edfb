"""Fused add+RMSNorm (kernel B4): plain version, Triton kernel and public
op, and the ``rmsnorm`` lowering claimant's op-pattern matcher
(``block.match``)."""
