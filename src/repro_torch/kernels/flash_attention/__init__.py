"""The ``flash_attention`` lowering claimant's op-pattern matcher (``block.match``)."""
