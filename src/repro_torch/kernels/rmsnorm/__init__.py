"""The ``rmsnorm`` lowering claimant's op-pattern matcher (``block.match``)."""
