"""WSP-fused optimizer: the port of ``repro/optim/fused.py``, the paper's
technique applied to the trainer on the port's lazy runtime.

The AdamW update for one parameter is ~12 elementwise array operations with
two contractible temporaries (m̂, v̂).  Here the update is RECORDED on the
lazy array API, partitioned by a WSP algorithm under a selectable cost
model, and executed as fused blocks.  On the card under
``backend="triton"`` the greedy partition is one block, which the
fused-block generator (kernel B1, ``kernels/fused_block/codegen.py``)
claims: one launch whose external set is exactly {p, g, m, v} in and
{p', m', v'} out.  The merge cache makes the partition cost amortize
across training steps.
"""

from __future__ import annotations

from typing import Dict

from ..core import lazy as bh
from ..core.lazy import Runtime


def record_adamw_tape(rt: Runtime, n: int, *, lr=1e-3, b1=0.9, b2=0.95,
                      eps=1e-8, weight_decay=0.1, c1=1.0, c2=1.0):
    """Record one parameter's AdamW update as array bytecode in ``rt``
    (the calling thread's active runtime).  Returns the output handles
    ``(p', m', v')``; the ``sync`` of the three flushes the update."""
    p = bh.random((n,))
    g = bh.random((n,))
    m = bh.random((n,))
    v = bh.random((n,))
    bh.flush()                       # p,g,m,v are external (pre-existing)

    m_new = m * b1 + g * (1.0 - b1)              # first moment
    v_new = v * b2 + g * g * (1.0 - b2)          # second moment
    mhat = m_new * (1.0 / c1)                    # bias correction (temp)
    vhat = v_new * (1.0 / c2)                    # bias correction (temp)
    denom = bh.sqrt(vhat) + eps                  # temp
    p_new = p - (mhat / denom + p * weight_decay) * lr
    # temporaries die here -> DEL ops -> array contraction candidates
    del mhat, vhat, denom
    bh.sync(p_new, m_new, v_new)
    return p_new, m_new, v_new


def fused_update_cost(n: int = 4096, algorithm: str = "greedy",
                      cost_model: str = "bohrium",
                      device=None) -> Dict[str, float]:
    """Partition the AdamW tape (on ``device``: the CUDA card unless
    given); report the cost and block counts of its flush."""
    with bh.fresh_runtime(algorithm=algorithm, cost_model=cost_model,
                          device=device) as rt:
        record_adamw_tape(rt, n)
        hist = [h for h in rt.history if not h.get("cached")]
    last = hist[-1]
    return {"cost": last["cost"], "n_blocks": last["n_blocks"],
            "n_ops": last["n_ops"]}
