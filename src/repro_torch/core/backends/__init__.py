"""Pluggable lowering backends for the PyTorch port.

``LoweringBackend`` is the protocol, the registry maps names to instances,
and :func:`select_lowering` is the per-block selection rule (the
cheapest claimant, preference order breaking ties) the scheduler's
**lower** stage runs.  The built-in backends register
on import:

* ``torch``  — one PyTorch call per op (claims everything; the floor);
* ``triton`` — one generated Triton kernel per block (claims what the
  fused-block generator expresses);
* ``flash_attention`` / ``rmsnorm`` / ``mamba_scan`` — hand-written-kernel
  claimants for LM blocks (op-pattern matchers over the row-replay
  generator; the ``backend="lm"`` stack).
"""

from __future__ import annotations

from typing import Tuple

from .base import (LoweringBackend, LoweringContext,         # noqa: F401
                   LoweringDecision, LoweringPolicy, available_backends,
                   get_backend, register_backend, select_lowering,
                   unregister_backend)
from .lm import (LM_STACK, FlashAttentionBackend,            # noqa: F401
                 MambaScanBackend, RMSNormBackend)
from .torch_floor import TorchFloorBackend                   # noqa: F401
from .triton import TritonBackend                            # noqa: F401

register_backend(TorchFloorBackend())
register_backend(TritonBackend())
register_backend(FlashAttentionBackend())
register_backend(RMSNormBackend())
register_backend(MambaScanBackend())


def default_stack(backend="torch") -> Tuple[str, ...]:
    """Resolve an executor's ``backend=`` parameter into the
    preference-ordered candidate list of the lowering policy.

    ``"torch"`` → the floor only; ``"lm"`` → the hand-written-kernel
    claimants over the generic generator over the floor (``lm.LM_STACK``);
    any other registered name (``"triton"``) → that backend with the floor
    for the blocks it declines; a tuple/list is taken verbatim."""
    if isinstance(backend, (tuple, list)):
        return tuple(backend)
    if backend == "torch":
        return ("torch",)
    if backend == "lm":
        return LM_STACK
    return (backend, "torch")
