"""WSP cost models (paper Def. 13 and §V-A Defs. 19–21) plus a GPU model
pricing device-memory time and kernel launches on an NVIDIA H100.

Every model exposes

* ``partition_cost(blocks)``  — cost of a whole partition (Def. 6 monotone),
* ``merge_saving(b1, b2)``    — cost(P) - cost(P/(B1,B2)), the weight-edge
  value (Prop. 1 generalized: computed as a difference of block costs so it
  is exact for ANY model, not just Bohrium's closed form).

All models are monotone: ``merge_saving >= 0`` always.  The paper models
are copies of ``repro.core.cost``; ``gpu`` takes the place of the
reference's ``tpu`` model with the same structure and H100 constants,
``gpu_dist`` of its ``tpu_dist``, ``gpu_fma`` of its ``tpu_fma``,
``comm`` is the reference's communication-aware model over the sharded
IR (``core/dist``), and
``calibrated`` prices ``gpu``'s structure with the fit that
``core.tuning`` measures on the card.
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
# NVLink 4 rate of one H100 SXM in one direction (data sheet: 900 GB/s
# both ways): the fabric rate of the ``comm`` and ``gpu_dist`` models and
# the calibration's default for a fabric slope it cannot identify.
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


#: the ``gpu_fma`` model's default bonus a contracted pair (seconds): the
#: median saving a pair, clamped at 0, of ``chip_smoke.py``'s ``FMA``
#: phase, which times every distinct block of the paper's programs that
#: holds a pair in both of B1's forms.  On an H100 80GB HBM3 at its
#: 700.00 W limit the median was -0.67 us over 18 blocks (-7.13 to +0.69
#: us): the contracting form saves nothing on these byte-bound blocks, so
#: the bonus is 0 and ``gpu_fma`` plans as ``gpu`` does (PERF.md §6)
FMA_BONUS_S = 0.0


class GPUFMACost(GPUCost):
    """``gpu`` plus a bonus for each multiply→add pair a block holds (the
    port's ``tpu_fma``, as ``gpu`` is its ``tpu``): B1's contracting form
    (``codegen.build_block_kernel(..., contract_fma=True)``, which a
    runtime under this model lowers every block through) computes each
    such pair as one fused multiply-add.  ``fma_bonus_s`` is the saving a
    pair; its default, :data:`FMA_BONUS_S`, is measured on the card, and
    where it is 0 this model plans exactly as ``gpu`` does.  Monotone:
    merging can only co-locate more pairs, so block costs only shrink."""

    def __init__(self, fma_bonus_s: float = FMA_BONUS_S, **kw):
        super().__init__(**kw)
        self.name = "gpu_fma"
        self.fma_bonus_s = fma_bonus_s

    def _fma_pairs(self, b: BlockInfo) -> int:
        writers: Dict[Tuple, str] = {}
        for op in b.ops:
            if op.out is not None:
                writers[view_key(op.out)] = op.opcode
        pairs = 0
        for op in b.ops:
            if op.opcode != "add":
                continue
            for v in op.in_views():
                if writers.get(view_key(v)) == "mul":
                    pairs += 1
                    break
        return pairs

    def block_cost(self, b: BlockInfo) -> float:
        base = super().block_cost(b)
        return base - self.fma_bonus_s * self._fma_pairs(b)

    def partition_cost(self, blocks: Sequence[BlockInfo]) -> float:
        # keep Def. 6(1) non-negativity: offset by the max possible bonus
        total = sum(self.block_cost(b) for b in blocks)
        n_ops = sum(len(b.ops) for b in blocks)
        return total + self.fma_bonus_s * n_ops


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

    * ``fabric_s_per_byte`` → a :class:`CommCost`-style unique-collective
      fabric term (``FABRIC_BW`` until a fit identifies a slope).

    With **zero samples** (no installed fit) every coefficient is the
    analytic default, i.e. the model prices exactly like ``gpu`` plus the
    fabric term, which is zero on tapes without COMM ops — "calibrated" is
    always safe to select.

    Monotone: identical term structure to ``GPUCost``/``CommCost`` with
    constant per-view/per-dispatch prices, so merging only deduplicates and
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
        self.fabric_s_per_byte = (fit.fabric_s_per_byte if fit is not None
                                  else 1.0 / FABRIC_BW)

    def block_cost(self, b: BlockInfo) -> float:
        base = super().block_cost(b)
        if base == 0.0:
            return base             # DEL/SYNC-only blocks dispatch nothing
        from .dist.reshard import block_comm_bytes
        return base + block_comm_bytes(b.ops) * self.fabric_s_per_byte

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


class GPUDistCost(_KernelAlignment, CostModel):
    """``gpu`` plus halo bytes over the fabric (the port's counterpart of
    the reference's ``tpu_dist``, its function unchanged).

    Bases may be sharded along one dimension across ``n_shards`` devices
    (``base.shard = (n_shards, dim)``).  An external view whose element
    span is *misaligned* with the shard grid (e.g. the shifted reads of a
    stencil) requires a halo exchange over NVLink; contracted temporaries
    never leave the kernel and need no halo.  Fusing stencil steps
    therefore removes whole halo exchanges, not just device-memory trips.

    Like the reference's, :meth:`halo_bytes` reads ``base.shard``, an
    attribute nothing in either package sets (the sharded IR's placement is
    ``base.shard_spec``), so the model prices exactly like ``gpu`` on every
    tape (ROADMAP C26).

    Monotone: per-view costs are constants; merging only deduplicates views
    and contracts arrays, so block costs only shrink.
    """

    def __init__(self, hbm_bw: float = HBM_BW, fabric_bw: float = FABRIC_BW,
                 launch_s: float = KERNEL_LAUNCH_S, align_codegen: bool = True):
        self.name = "gpu_dist"
        self.unit = "bytes"
        self.hbm_bw = hbm_bw
        self.fabric_bw = fabric_bw
        self.launch_s = launch_s
        self.align_codegen = align_codegen

    @staticmethod
    def halo_bytes(v: View) -> int:
        shard = getattr(v.base, "shard", None)
        if not shard:
            return 0
        n_shards, dim = shard
        if n_shards <= 1 or dim >= len(v.shape):
            return 0
        # slab = bytes per unit length along the sharded dim
        slab = v.nbytes // max(1, v.shape[dim])
        # shift of this view against the shard grid along `dim`
        stride = v.strides[dim] if v.strides[dim] != 0 else 1
        shift = (v.offset // abs(stride)) % max(1, v.shape[dim] // n_shards or 1)
        if shift == 0 and v.shape[dim] % n_shards == 0:
            return 0
        width = min(abs(shift) if shift else 1, 4)   # halo width in elements
        return (n_shards - 1) * width * slab

    def block_cost(self, b: BlockInfo) -> float:
        if all(o.is_system() for o in b.ops):
            return 0.0
        reads, writes = b.ext_views()
        hbm = sum(v.nbytes for v in (*reads, *writes)) + gather_table_bytes(b)
        halo = sum(self.halo_bytes(v) for v in (*reads, *writes))
        return (hbm / self.hbm_bw + halo / self.fabric_bw
                + self.launch_s * self._dispatches(b))


class CommCost(CostModel):
    """Communication-aware WSP over the sharded IR (``core/dist``): the
    paper's fusion criterion "shape compatibility, data reusability AND
    communication", priced on explicit COMM graph nodes.

    A block costs its per-device memory traffic time (ext bytes divided by
    the shard count of each base's placement) plus its interconnect time:
    the fabric bytes of the block's *unique* collectives
    (``comm_op_bytes``, deduplicated on ``(kind, source view, target
    placement)``).  The resharding pass inserts one COMM per consuming read
    site, so merging identical reshards deduplicates collectives — the
    model's ``merge_saving`` prices exactly the interconnect bytes that
    fusion elides, alongside the usual dedup/contraction savings.

    Monotone: merging only deduplicates ext views, contracts temporaries and
    deduplicates collectives — every term shrinks.  Sparse: a non-zero
    saving needs a shared identical view key (incl. the COMM dedup case) or
    a creator/reader/writer/deleter pair, so the saving-support weight graph
    of ``PartitionState`` applies.
    """

    sparse_weights = True

    def __init__(self, hbm_bw: float = HBM_BW, fabric_bw: float = FABRIC_BW):
        self.name = "comm"
        self.unit = "bytes"
        self.hbm_bw = hbm_bw
        self.fabric_bw = fabric_bw

    @staticmethod
    def _local_nbytes(v: View) -> float:
        from .dist.spec import spec_of
        spec = spec_of(v.base)
        return v.nbytes / (spec.n_shards if spec is not None else 1)

    def block_cost(self, b: BlockInfo) -> float:
        if all(o.is_system() for o in b.ops):
            return 0.0
        from .dist.reshard import block_comm_bytes
        reads, writes = b.ext_views()
        hbm = sum(self._local_nbytes(v) for v in (*reads, *writes))
        return hbm / self.hbm_bw + block_comm_bytes(b.ops) / self.fabric_bw


_MODELS = {
    "bohrium": BohriumCost,
    "calibrated": CalibratedCost,
    "comm": CommCost,
    "gpu": GPUCost,
    "gpu_dist": GPUDistCost,
    "gpu_fma": GPUFMACost,
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
    * ``"gpu_dist"``     — ``gpu`` plus halo bytes over NVLink (the
      reference's ``tpu_dist``)
    * ``"gpu_fma"``      — ``gpu`` plus a multiply→add co-location bonus
      (the reference's ``tpu_fma``); a runtime under it lowers B1 through
      its contracting form (:func:`contracts_fma`)
    * ``"comm"``         — per-device bytes plus the unique collectives'
      fabric bytes over the sharded IR (``core/dist``)
    * ``"calibrated"``   — ``gpu``'s structure with measured, fitted prices
      (per-backend dispatch overhead and byte slope, the fabric term;
      ``core.tuning``)

    All models are monotone (``merge_saving >= 0``); models with
    ``sparse_weights=True`` opt into the sparse saving-support weight graph
    (DESIGN.md §5)."""
    try:
        return _MODELS[name](**kw)
    except KeyError:
        raise ValueError(f"unknown cost model {name!r}; have {sorted(_MODELS)}")


def contracts_fma(name: str) -> bool:
    """Whether a runtime under cost model ``name`` lowers B1 blocks
    through the generator's contracting form: under ``gpu_fma`` only;
    every other model keeps the form bitwise with the torch floor."""
    return name == "gpu_fma"


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
