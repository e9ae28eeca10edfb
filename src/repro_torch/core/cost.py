"""WSP cost models (paper Def. 13 and §V-A Defs. 19–21) plus a GPU model
pricing device-memory time and kernel launches on an NVIDIA H100.

Every model exposes

* ``partition_cost(blocks)``  — cost of a whole partition (Def. 6 monotone),
* ``merge_saving(b1, b2)``    — cost(P) - cost(P/(B1,B2)), the weight-edge
  value (Prop. 1 generalized: computed as a difference of block costs so it
  is exact for ANY model, not just Bohrium's closed form).

All models are monotone: ``merge_saving >= 0`` always.  The paper models
are copies of ``repro.core.cost``; ``gpu`` takes the place of the
reference's ``tpu`` model with the same structure and H100 constants.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .blocks import BlockInfo, view_key
from .ir import Op, View

# NVIDIA H100 SXM device-memory rate (data sheet).
HBM_BW = 3.35e12          # bytes/s
# Per-block launch cost of one fused-block kernel: the host time of one
# warm ``fused_block`` wrapper call at a tiny size (launch + bookkeeping),
# as ``chip_smoke.py`` measures it (45.24 us on an H100 80GB HBM3 at its
# 700 W limit; PERF.md).
KERNEL_LAUNCH_S = 45.24e-6


def gather_table_bytes(b: BlockInfo) -> int:
    """Unique gathered-table bytes of a block (deduplicated on view key).

    A ``gather``'s table is read at data-dependent offsets, which do not
    stream at the sequential device-memory rate, so ``gpu`` prices each
    unique table view one extra trip on top of the ordinary ext term.
    Constant per-view price, dedup-only under merges → monotone."""
    seen = set()
    total = 0
    for op in b.ops:
        if op.opcode == "gather" and op.inputs \
                and isinstance(op.inputs[0], View):
            k = view_key(op.inputs[0])
            if k not in seen:
                seen.add(k)
                total += op.inputs[0].nbytes
    return total


class CostModel:
    name: str = "abstract"
    unit: str = "elements"
    # True when merge_saving(b1, b2) can only be non-zero if the blocks
    # structurally interact (shared identical views, creator/reader,
    # writer/deleter, creator/deleter pairs).  Lets PartitionState build its
    # weight graph from those support pairs instead of all V² pairs
    # (DESIGN.md §5).  Models with a per-block constant term (launch
    # overhead, block count) reward merging ANY pair and must stay dense.
    sparse_weights: bool = False

    def prepare(self, ops: Sequence[Op]) -> None:   # optional precompute
        pass

    def block_cost(self, b: BlockInfo) -> float:
        raise NotImplementedError

    def partition_cost(self, blocks: Sequence[BlockInfo]) -> float:
        return sum(self.block_cost(b) for b in blocks)

    def merge_saving(self, b1: BlockInfo, b2: BlockInfo) -> float:
        merged = b1.merged_with(b2)
        return self.block_cost(b1) + self.block_cost(b2) - self.block_cost(merged)


class BohriumCost(CostModel):
    """Def. 13: sum over blocks of unique external accesses ``||ext[B]||``.

    ``unit='elements'`` reproduces the paper's figures (Fig. 3 cost 94);
    ``unit='bytes'`` is the same model scaled by dtype itemsize.
    """

    sparse_weights = True

    def __init__(self, unit: str = "elements"):
        self.unit = unit
        self.name = "bohrium"

    def block_cost(self, b: BlockInfo) -> float:
        return float(b.ext_size(self.unit))


class MaxContractCost(CostModel):
    """Def. 19: arrays NOT contracted each cost 1."""

    sparse_weights = True

    def __init__(self):
        self.name = "max_contract"
        self._total_new = 0

    def prepare(self, ops: Sequence[Op]) -> None:
        self._total_new = len({b.uid for op in ops for b in op.new_bases})

    def block_cost(self, b: BlockInfo) -> float:
        return -float(b.n_contractions())

    def partition_cost(self, blocks: Sequence[BlockInfo]) -> float:
        return self._total_new + sum(self.block_cost(b) for b in blocks)


class MaxLocalityCost(CostModel):
    """Def. 20: each unordered pair of identical array accesses in different
    blocks costs 1 (fusing four identical accesses saves C(4,2)=6)."""

    sparse_weights = True

    def __init__(self):
        self.name = "max_locality"
        self._pair: Dict[Tuple[int, int], float] = {}
        self._total = 0.0

    @staticmethod
    def _ext_io(op: Op):
        if op.is_system():
            return frozenset(), frozenset()
        new = {b.uid for b in op.new_bases}
        dl = {b.uid for b in op.del_bases}
        ext = {view_key(v) for v in op.in_views() if v.base.uid not in new}
        ext |= {view_key(v) for v in op.out_views() if v.base.uid not in dl}
        io = {view_key(v) for v in (*op.in_views(), *op.out_views())}
        return frozenset(ext), frozenset(io)

    def prepare(self, ops: Sequence[Op]) -> None:
        exts, ios = {}, {}
        for op in ops:
            exts[op.uid], ios[op.uid] = self._ext_io(op)
        self._pair = {}
        self._total = 0.0
        uids = [op.uid for op in ops]
        for a in range(len(uids)):
            for b in range(a + 1, len(uids)):
                u, v = uids[a], uids[b]
                s = 0.5 * (len(exts[u] & ios[v]) + len(exts[v] & ios[u]))
                if s:
                    self._pair[(u, v)] = self._pair[(v, u)] = s
                    self._total += s

    def _within(self, b: BlockInfo) -> float:
        uids = [o.uid for o in b.ops]
        s = 0.0
        for i in range(len(uids)):
            for j in range(i + 1, len(uids)):
                s += self._pair.get((uids[i], uids[j]), 0.0)
        return s

    def block_cost(self, b: BlockInfo) -> float:
        return -self._within(b)

    def partition_cost(self, blocks: Sequence[BlockInfo]) -> float:
        return self._total + sum(self.block_cost(b) for b in blocks)

    def merge_saving(self, b1: BlockInfo, b2: BlockInfo) -> float:
        s = 0.0
        for o1 in b1.ops:
            for o2 in b2.ops:
                s += self._pair.get((o1.uid, o2.uid), 0.0)
        return s


class RobinsonCost(CostModel):
    """Def. 21: ``|P| + N*MaxContract + N^2*MaxLocality`` (lexicographic)."""

    def __init__(self):
        self.name = "robinson"
        self.mc = MaxContractCost()
        self.ml = MaxLocalityCost()
        self._n = 1

    def prepare(self, ops: Sequence[Op]) -> None:
        self.mc.prepare(ops)
        self.ml.prepare(ops)
        bases = {v.base.uid for op in ops
                 for v in (*op.in_views(), *op.out_views())}
        self._n = max(2, len(bases))

    def partition_cost(self, blocks: Sequence[BlockInfo]) -> float:
        n = self._n
        return (len(blocks) + n * self.mc.partition_cost(blocks)
                + n * n * self.ml.partition_cost(blocks))

    def block_cost(self, b: BlockInfo) -> float:  # decomposable parts only
        n = self._n
        return 1 + n * self.mc.block_cost(b) + n * n * self.ml.block_cost(b)

    def merge_saving(self, b1: BlockInfo, b2: BlockInfo) -> float:
        n = self._n
        mc_gain = (b1.merged_with(b2).n_contractions()
                   - b1.n_contractions() - b2.n_contractions())
        return 1 + n * mc_gain + n * n * self.ml.merge_saving(b1, b2)


# ---------------------------------------------------------------------------
# The GPU model (the reference's ``tpu`` structure, H100 constants).
# ---------------------------------------------------------------------------

class _KernelAlignment:
    """Mixin pricing whether a block actually lowers through the fused-block
    Triton generator (``kernels.fused_block.codegen``).

    A block the generator cannot express as ONE kernel runs on the torch
    floor, one library kernel per op — modelled as one extra dispatch
    (``2 * launch_s`` instead of one), the rule the reference applies to
    its XLA floor.  This aligns the priced fusibility with kernel
    expressibility: greedy stops rewarding merges whose only "saving" would
    be lost to a fallback.

    Monotonicity (Def. 6) is preserved: the expressibility analysis looks
    only at opcodes/domains/views/axes — never at DEL/SYNC placement — so a
    merged block costs at most ``2 * launch_s`` while its parts paid at
    least ``2 * launch_s`` combined, and the byte term only shrinks."""

    align_codegen: bool = True
    _expr_cache: Optional[Dict[Tuple[int, ...], bool]] = None

    def _dispatches(self, b: BlockInfo) -> int:
        if not self.align_codegen:
            return 1
        if self._expr_cache is None:
            self._expr_cache = {}
        key = tuple(o.uid for o in b.ops if not o.is_system())
        hit = self._expr_cache.get(key)
        if hit is None:
            from ..kernels.fused_block.codegen import block_lower_reason
            hit = block_lower_reason(b.ops) is None
            self._expr_cache[key] = hit
        return 1 if hit else 2


class GPUCost(_KernelAlignment, CostModel):
    """Bohrium's Def. 13 with hardware units: device-memory traffic time
    plus a per-block launch cost.  Merging blocks saves both deduplicated
    traffic (data locality / array contraction — bytes that stay in
    registers) and one kernel launch.  Blocks the Triton generator cannot
    express as a single kernel pay a second launch (see
    :class:`_KernelAlignment`).  Monotone: every term only shrinks under
    merges."""

    def __init__(self, hbm_bw: float = HBM_BW, launch_s: float = KERNEL_LAUNCH_S,
                 align_codegen: bool = True):
        self.name = "gpu"
        self.unit = "bytes"
        self.hbm_bw = hbm_bw
        self.launch_s = launch_s
        self.align_codegen = align_codegen

    def block_cost(self, b: BlockInfo) -> float:
        if all(o.is_system() for o in b.ops):
            return 0.0   # DEL/SYNC-only blocks dispatch nothing
        return ((b.ext_size("bytes") + gather_table_bytes(b)) / self.hbm_bw
                + self.launch_s * self._dispatches(b))


_MODELS = {
    "bohrium": BohriumCost,
    "gpu": GPUCost,
    "max_contract": MaxContractCost,
    "max_locality": MaxLocalityCost,
    "robinson": RobinsonCost,
}


def make_cost_model(name: str, **kw) -> CostModel:
    """Instantiate a registered WSP cost model by name.

    Registry (``**kw`` forwards to the model constructor):

    * ``"bohrium"``      — Def. 13, unique external accesses (paper default)
    * ``"max_contract"`` — Def. 19, non-contracted arrays
    * ``"max_locality"`` — Def. 20, split identical access pairs
    * ``"robinson"``     — Def. 21, lexicographic combination
    * ``"gpu"``          — device-memory time + launches, Triton-codegen
      aligned

    All models are monotone (``merge_saving >= 0``); models with
    ``sparse_weights=True`` opt into the sparse saving-support weight graph
    (DESIGN.md §5)."""
    try:
        return _MODELS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown cost model {name!r}; have {sorted(_MODELS)}")
