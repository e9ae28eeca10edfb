"""Optimizer: the port of ``repro/optim`` (AdamW with int8/bf16/factored
moments, the cosine schedule, the WSP-fused update tape)."""

from .adamw import adamw_init, adamw_update, OptState        # noqa: F401
from .schedule import cosine_warmup                          # noqa: F401
