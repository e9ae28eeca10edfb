"""WSP cost models (paper Def. 13 and §V-A Defs. 19–21) plus a GPU model
pricing device-memory time and kernel launches on an NVIDIA H100.

Every model exposes

* ``partition_cost(blocks)``  — cost of a whole partition (Def. 6 monotone),
* ``merge_saving(b1, b2)``    — cost(P) - cost(P/(B1,B2)), the weight-edge
  value (Prop. 1 generalized: computed as a difference of block costs so it
  is exact for ANY model, not just Bohrium's closed form).

All models are monotone: ``merge_saving >= 0`` always.  The paper models
are copies of ``repro.core.cost``; ``gpu`` takes the place of the
reference's ``tpu`` model with the same structure and H100 constants, and
``calibrated`` prices ``gpu``'s structure with the fit that
``core.tuning`` measures on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from .blocks import BlockInfo, view_key
from .ir import COMM_OPS, Op, View

# NVIDIA H100 SXM device-memory rate (data sheet).
HBM_BW = 3.35e12          # bytes/s
# Per-block launch cost of one fused-block kernel: the host time of one
# warm ``fused_block`` wrapper call at a tiny size (launch + bookkeeping),
# as ``chip_smoke.py`` measures it (45.24 us on an H100 80GB HBM3 at its
# 700 W limit; PERF.md).
KERNEL_LAUNCH_S = 45.24e-6
# NVLink 4 rate of one H100 SXM in one direction (data sheet: 900 GB/s
# both ways).  Only the calibration's default for a fabric slope it cannot
# identify: no backend of the port moves bytes between cards yet.
FABRIC_BW = 450e9

# Version of the port's cost-model feature space — the quantities a
# measured profile records (dispatch counts, ext device-memory bytes,
# fabric bytes).  Persisted profiles (``tuning.profile``) embed it; bump it
# whenever a pricing feature changes meaning, and every stale profile on
# disk is refused instead of silently miscalibrating a fit.  The port's own
# number: a profile of the JAX package priced other backends.
COST_REGISTRY_VERSION = 1


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

    def dispatch_price(self, n_dispatches: int,
                       backend: Optional[str] = None,
                       amortize: int = 1) -> float:
        """Price of ``n`` executable dispatches for one block — the
        per-backend term the scheduler's lower stage minimizes when picking
        a block's lowering backend.  Models with a ``launch_s`` term
        (``gpu``) price dispatches in seconds, matching their
        partition-time ``_KernelAlignment`` pricing; abstract models price
        the dispatch count itself.  ``backend`` names the candidate being
        priced (the analytic models ignore it).  ``amortize`` is the unroll
        of a fused cross-flush loop: there the launch overhead is paid per
        drain rather than per iteration, so the per-iteration price divides
        by it."""
        return (getattr(self, "launch_s", 1.0) * float(n_dispatches)
                / max(1, amortize))

    def lowering_price(self, n_dispatches: int, ext_bytes: float,
                       backend: Optional[str] = None,
                       amortize: int = 1) -> float:
        """Full per-backend price of running one block on ``backend`` — what
        ``select_lowering`` minimizes.  The analytic default is just
        :meth:`dispatch_price`: every backend moves the same external
        bytes at the same assumed bandwidth, so the byte term cancels out
        of the comparison.  Only the dispatch term amortizes under
        ``amortize`` — external bytes move every loop iteration."""
        return self.dispatch_price(n_dispatches, backend=backend,
                                   amortize=amortize)


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


def closed_form_saving(b1: BlockInfo, b2: BlockInfo,
                       unit: str = "elements") -> float:
    """Prop. 1 closed form — ``||ext∩ext|| + ||new[B1]∩in[B2]|| +
    ||out[B1]∩del[B2]||`` (b1 must precede b2).  Used only to *verify* the
    generic difference computation in tests."""

    def sz(v: View) -> int:
        return v.size if unit == "elements" else v.nbytes

    r1, w1 = b1.ext_views()
    r2, w2 = b2.ext_views()
    k1r = {view_key(v) for v in r1}
    k1w = {view_key(v) for v in w1}
    s = sum(sz(v) for v in r2 if view_key(v) in k1r)
    s += sum(sz(v) for v in w2 if view_key(v) in k1w)
    s += sum(sz(v) for v in b2.in_map.values() if v.base.uid in b1.new_bases)
    s += sum(sz(v) for v in b1.out_map.values() if v.base.uid in b2.del_bases)
    return float(s)


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


class CalibratedCost(GPUCost):
    """``gpu``'s structure with MEASURED prices (the port's copy of the
    reference's ``calibrated`` model).

    The same monotone decomposition as :class:`GPUCost` — device-memory
    traffic time plus per-dispatch overhead — with every coefficient from
    the least-squares fit installed process-wide (``tuning.install_fit`` /
    ``tuning.calibrate``) instead of data-sheet constants:

    * ``hbm_s_per_byte``    → the byte term,
    * ``launch_s[backend]`` → per-BACKEND dispatch overhead.  Partitioning
      prices a block's dispatch term at the *cheapest* fitted backend (the
      lower stage will route it there); ``dispatch_price`` and
      ``lowering_price`` price each lowering candidate at its own fitted
      overhead and byte slope, so a backend that measures slow loses
      blocks it would win on dispatch counts alone.

    With **zero samples** (no installed fit) every coefficient is the
    analytic default, i.e. the model prices exactly like ``gpu`` —
    "calibrated" is always safe to select.

    The reference adds a fabric term for COMM ops; the port has no
    resharding pass to count their bytes (ROADMAP A10b), so a block that
    holds a COMM op raises instead of being priced at zero.

    Monotone: identical term structure to ``GPUCost`` with constant
    per-view/per-dispatch prices, so merging only deduplicates and
    contracts — every term shrinks.
    """

    def __init__(self, fit=None, align_codegen: bool = True):
        if fit is None:
            from .tuning.calibrate import current_fit
            fit = current_fit()
        self.fit = fit
        launch = (fit.launch_for(None) if fit is not None else None)
        hbm_bw = (1.0 / fit.hbm_s_per_byte
                  if fit is not None and fit.hbm_s_per_byte > 0 else HBM_BW)
        super().__init__(hbm_bw=hbm_bw,
                         launch_s=launch if launch is not None
                         else KERNEL_LAUNCH_S,
                         align_codegen=align_codegen)
        self.name = "calibrated"

    def block_cost(self, b: BlockInfo) -> float:
        for o in b.ops:
            if o.opcode in COMM_OPS:
                raise NotImplementedError(
                    f"the calibrated model cannot price a {o.opcode!r} op: "
                    "its fabric bytes need the resharding pass, which is "
                    "not ported yet (ROADMAP A10b)")
        return super().block_cost(b)

    def dispatch_price(self, n_dispatches: int,
                       backend: Optional[str] = None,
                       amortize: int = 1) -> float:
        per = self.fit.launch_for(backend) if self.fit is not None else None
        return ((per if per is not None else self.launch_s)
                * float(n_dispatches) / max(1, amortize))

    def lowering_price(self, n_dispatches: int, ext_bytes: float,
                       backend: Optional[str] = None,
                       amortize: int = 1) -> float:
        slope = (self.fit.hbm_slope_for(backend) if self.fit is not None
                 else None)
        if slope is None:
            slope = 1.0 / self.hbm_bw
        return (self.dispatch_price(n_dispatches, backend=backend,
                                    amortize=amortize)
                + slope * float(ext_bytes))


_MODELS = {
    "bohrium": BohriumCost,
    "calibrated": CalibratedCost,
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
    * ``"calibrated"``   — ``gpu``'s structure with measured, fitted prices
      (per-backend dispatch overhead and byte slope; ``core.tuning``)

    All models are monotone (``merge_saving >= 0``); models with
    ``sparse_weights=True`` opt into the sparse saving-support weight graph
    (DESIGN.md §5)."""
    try:
        return _MODELS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown cost model {name!r}; have {sorted(_MODELS)}")


def model_cache_token(name: str) -> Tuple:
    """Extra merge-cache identity of a cost model beyond its name.

    The ``calibrated`` model's prices change whenever a new fit is
    installed, so its token carries the calibration epoch — plans priced
    under an old fit are never replayed after re-calibration.  Analytic
    models are fully identified by their name."""
    if name == "calibrated":
        from .tuning.calibrate import current_epoch
        return ("calibrated_epoch", current_epoch())
    return ()
