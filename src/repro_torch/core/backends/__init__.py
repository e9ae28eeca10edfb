"""Pluggable lowering backends for the PyTorch port.

``LoweringBackend`` is the protocol, the registry maps names to instances,
and :func:`select_lowering` is the per-block selection rule (first
claimant in preference order) the scheduler's **lower** stage runs.  The built-in backends register
on import:

* ``torch``  — one PyTorch call per op (claims everything; the floor);
* ``triton`` — one generated Triton kernel per block (claims what the
  fused-block generator expresses).
"""

from __future__ import annotations

from typing import Tuple

from .base import (LoweringBackend, LoweringContext,         # noqa: F401
                   LoweringDecision, LoweringPolicy, available_backends,
                   get_backend, register_backend, select_lowering,
                   unregister_backend)
from .torch_floor import TorchFloorBackend                   # noqa: F401
from .triton import TritonBackend                            # noqa: F401

register_backend(TorchFloorBackend())
register_backend(TritonBackend())


def default_stack(backend="torch") -> Tuple[str, ...]:
    """Resolve an executor's ``backend=`` parameter into the
    preference-ordered candidate list of the lowering policy.

    ``"torch"`` → the floor only; any other registered name (``"triton"``)
    → that backend with the floor for the blocks it declines; a tuple/list
    is taken verbatim."""
    if isinstance(backend, (tuple, list)):
        return tuple(backend)
    if backend == "torch":
        return ("torch",)
    return (backend, "torch")
