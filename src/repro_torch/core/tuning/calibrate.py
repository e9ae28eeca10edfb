"""Least-squares cost-model calibration from measured block profiles (the
port's copy of ``repro.core.tuning.calibrate``).

The analytic ``gpu`` model prices a block as

    t(B) = launch_s * dispatches + hbm_bytes / HBM_BW

with an H100 data-sheet rate and one measured launch price.  The
calibrator fits the same coefficient families from a
:class:`~repro_torch.core.tuning.profile.Profile` of measured warm
dispatches on the card:

* ``launch_s[backend]`` — per-dispatch overhead, fitted PER BACKEND (the
  torch floor launches one PyTorch kernel per op where the ``triton``
  backend launches one kernel per block, though both answer 1-2
  ``dispatches``, so the floor's fitted price absorbs its op count);
* ``hbm_s_per_byte``    — seconds per external device-memory byte;
* ``fabric_s_per_byte`` — seconds per fabric byte (fitted only when
  samples carry fabric bytes, which no backend of the port records yet).

Each ``(backend, signature)`` key contributes its *minimum* observed wall
time as one equation; the system is solved by ordinary least squares and
the coefficients clamped to physical floors (time never runs backwards).
Keys with too few distinct features fall back to the analytic defaults for
whatever could not be identified.

``install_fit`` publishes a fit process-wide; ``make_cost_model
("calibrated")`` picks it up, and every ``install_fit`` bumps a calibration
*epoch* that the scheduler mixes into the merge-cache key — re-fitting
invalidates cached partitions and lowering decisions priced under the old
coefficients.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .profile import Profile, Profiler

# physical floors for fitted coefficients: least squares on noisy, nearly
# collinear features can return ~0 or negative terms; a price of exactly 0
# would make the partitioner blind to that resource.
MIN_LAUNCH_S = 1e-8
MIN_S_PER_BYTE = 1e-15


@dataclass(frozen=True)
class CalibratedFit:
    """Fitted cost coefficients plus fit diagnostics."""

    launch_s: Dict[str, float] = field(default_factory=dict)  # per backend
    hbm_slope_s: Dict[str, float] = field(default_factory=dict)  # per backend
    hbm_s_per_byte: float = 0.0   # cheapest backend's slope (partition term)
    fabric_s_per_byte: float = 0.0
    n_samples: int = 0
    n_keys: int = 0
    residual_s: float = 0.0       # RMS residual of the fit, in seconds
    epoch: int = 0                # set by install_fit

    def launch_for(self, backend: Optional[str]) -> Optional[float]:
        """Fitted per-dispatch seconds for ``backend``; the cheapest fitted
        backend when ``backend`` is None/unfitted (the partitioner prices a
        block's dispatch term before the lower stage picks who runs it)."""
        if backend is not None and backend in self.launch_s:
            return self.launch_s[backend]
        if self.launch_s:
            return min(self.launch_s.values())
        return None

    def hbm_slope_for(self, backend: Optional[str]) -> Optional[float]:
        """Fitted seconds-per-external-byte for ``backend`` (None when the
        backend's byte slope was unidentifiable from the samples)."""
        if backend is not None and backend in self.hbm_slope_s:
            return self.hbm_slope_s[backend]
        if self.hbm_slope_s:
            return min(self.hbm_slope_s.values())
        return None


def fit_profile(profile: Profile) -> Optional[CalibratedFit]:
    """Fit coefficients from a profile; None when there are no samples.

    The system is solved PER BACKEND — one least-squares problem per
    backend over its ``(backend, sig)`` keys:

        wall = launch_s[b]*dispatches + c_hbm[b]*hbm (+ c_fabric*fabric)

    Fitting backends jointly with one shared byte column is
    ill-conditioned: both backends see the same byte features, so the
    solver can trade a backend's real per-dispatch overhead against the
    shared slope and return garbage intercepts.  Per-backend systems keep
    each intercept identified by that backend's own size sweep.  A column
    only joins a backend's system when its feature *varies* across keys
    (a constant column is indistinguishable from the intercept); anything
    unidentifiable keeps the analytic default.

    The published scalar ``hbm_s_per_byte``/``fabric_s_per_byte`` are the
    cheapest fitted slopes across backends — partition pricing assumes the
    lower stage routes each block to the backend that runs it cheapest,
    which is exactly what ``dispatch_price`` makes it do.
    """
    best = profile.grouped()
    if not best:
        return None
    from ..cost import FABRIC_BW, HBM_BW
    launch: Dict[str, float] = {}
    hbm_slopes: Dict[str, float] = {}
    fab_slopes: Dict[str, float] = {}
    sq_err = 0.0
    for backend in sorted({b for b, _ in best}):
        keys = [s for (b, _), s in sorted(best.items()) if b == backend]
        fit_hbm = len({s.hbm_bytes for s in keys}) > 1
        fit_fab = len({s.fabric_bytes for s in keys}) > 1
        cols = 1 + int(fit_hbm) + int(fit_fab)
        X = np.zeros((len(keys), cols))
        yv = np.array([s.wall_s for s in keys])
        X[:, 0] = [s.dispatches for s in keys]
        if fit_hbm:
            X[:, 1] = [s.hbm_bytes for s in keys]
        if fit_fab:
            X[:, 1 + int(fit_hbm)] = [s.fabric_bytes for s in keys]
        coef, *_ = np.linalg.lstsq(X, yv, rcond=None)
        # Trim outliers RELATIVE TO THE FIT, then refit once: even per-key
        # minima keep the odd GC pause when a key was only dispatched warm
        # once or twice, and a single 20x outlier has enough leverage to
        # push an intercept negative.  (A fixed clamp at k*median(wall)
        # would instead truncate legitimately byte-bound large blocks —
        # their walls sit far above the median of a tiny-block-heavy
        # workload — biasing the slope low; residual-based trimming keeps
        # them because their *predicted* walls are large too.)
        pred = X @ coef
        keep = yv <= 5.0 * np.maximum(pred, float(np.min(yv)))
        if int(keep.sum()) >= cols and not bool(keep.all()):
            X, yv = X[keep], yv[keep]
            coef, *_ = np.linalg.lstsq(X, yv, rcond=None)
        launch[backend] = max(MIN_LAUNCH_S, float(coef[0]))
        if fit_hbm:
            hbm_slopes[backend] = max(MIN_S_PER_BYTE, float(coef[1]))
        if fit_fab:
            fab_slopes[backend] = max(MIN_S_PER_BYTE,
                                      float(coef[1 + int(fit_hbm)]))
        sq_err += float(np.sum((X @ coef - yv) ** 2))
    c_hbm = min(hbm_slopes.values()) if hbm_slopes else 1.0 / HBM_BW
    c_fab = min(fab_slopes.values()) if fab_slopes else 1.0 / FABRIC_BW
    return CalibratedFit(launch_s=launch, hbm_slope_s=hbm_slopes,
                         hbm_s_per_byte=c_hbm, fabric_s_per_byte=c_fab,
                         n_samples=len(profile), n_keys=len(best),
                         residual_s=float(np.sqrt(sq_err / len(best))))


# ---------------------------------------------------------------------------
# Process-wide active fit (what make_cost_model("calibrated") prices with)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[CalibratedFit] = None
_EPOCH = 0
#: serializes epoch bump + publication: two concurrent installs must not
#: share an epoch, or merge-cache/plan-store keys priced under different
#: fits would collide (DESIGN.md §18)
_INSTALL_LOCK = threading.Lock()


def install_fit(fit: Optional[CalibratedFit]) -> Optional[CalibratedFit]:
    """Publish ``fit`` as the process-wide calibration (None clears it).
    Bumps the calibration epoch, which the scheduler mixes into merge-cache
    keys — cached plans priced under the old fit are never replayed.
    Thread-safe: epoch bump and publication happen under one lock, so every
    install gets a distinct epoch and readers never see a new fit with an
    old epoch."""
    global _ACTIVE, _EPOCH
    with _INSTALL_LOCK:
        _EPOCH += 1
        if fit is not None:
            fit = CalibratedFit(**{**fit.__dict__, "epoch": _EPOCH})
        _ACTIVE = fit
        return fit


def current_fit() -> Optional[CalibratedFit]:
    return _ACTIVE


def clear_fit() -> None:
    install_fit(None)


def current_epoch() -> int:
    return _EPOCH


def load_and_install(path: str) -> CalibratedFit:
    """Warm start: refit from a persisted profile and install the result.
    Raises ``StaleProfileError`` if the profile predates the current
    cost-model registry version."""
    fit = fit_profile(Profile.load(path))
    if fit is None:
        raise ValueError(f"{path}: profile holds no samples")
    return install_fit(fit)


# ---------------------------------------------------------------------------
# The calibration loop
# ---------------------------------------------------------------------------

#: the calibration's default array sizes in float64 elements, 32 KiB to
#: 32 MiB an array: from launch-bound to bandwidth-bound on an H100, so the
#: byte slope is identified apart from the launch price
CARD_SIZES = (2 ** 12, 2 ** 18, 2 ** 22)


def calibrate(seeds: Sequence[int] = range(4), *, repeats: int = 3,
              sizes: Sequence[int] = CARD_SIZES,
              backends: Tuple[str, ...] = ("torch", "triton"),
              save: Optional[str] = None,
              install: bool = True, device=None) -> CalibratedFit:
    """Measure → fit → (install) in one call.

    Runs seeded ``repro_torch.testing.tapegen`` workloads
    (transcendental-rich, non-exact mode — calibration wants realistic
    arithmetic, not the fuzzer's dyadic subset) under each backend policy
    with a profiler attached, on ``device`` (the CUDA card unless given,
    as every entry point of the port; without a card and without
    ``device="cpu"`` it raises).  Each program is flushed ``repeats``
    times so executables are warm (only warm dispatches are recorded), and
    each runs at several ``sizes`` so the per-byte slope is identified
    separately from the per-dispatch intercept.  The fitted coefficients
    are installed process-wide (``install=False`` to just return them) and
    the raw profile optionally persisted to ``save`` for warm restarts via
    :func:`load_and_install`.
    """
    from ..device import resolve_device
    from ..lazy import fresh_runtime
    from ...testing.tapegen import TapeProgram
    device = resolve_device(device)
    profiler = Profiler()
    for backend in backends:
        for size in sizes:
            for seed in seeds:
                prog = TapeProgram(seed, size=size, exact=False)
                with fresh_runtime(algorithm="greedy", cost_model="bohrium",
                                   backend=backend, profiler=profiler,
                                   device=device):
                    # flush 1 is cold, and flush 2's tape still differs
                    # from flush 1 (it carries the previous iteration's
                    # DELs), so the first warm, timed replay of every
                    # block can be as late as flush 3
                    for _ in range(max(3, repeats)):
                        prog.run_current()
    fit = fit_profile(profiler.profile)
    if fit is None:
        raise RuntimeError("calibration workloads produced no warm samples "
                           "— increase repeats/seeds")
    if save is not None:
        profiler.profile.save(save)
    if install:
        fit = install_fit(fit)
    return fit
