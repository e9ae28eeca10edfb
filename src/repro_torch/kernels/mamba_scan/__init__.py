"""The ``mamba_scan`` lowering claimant's op-pattern matcher (``block.match``)."""
