"""Metrics registry: counters, gauges and histograms with labels
(DESIGN.md §17), plus the legacy-dict facade over it.

Naming scheme: dotted lowercase ``<subsystem>.<metric>`` (``executor.
blocks_run``, ``executor.backend_blocks``, ``runtime.flush_wall_s``,
``loop.pending``).  Labels are positional tuples declared once per metric
(``("backend",)``, ``("backend", "reason")``); a metric value is stored per
label-value tuple, insertion-ordered, so views and snapshots render in the
order values first appeared — exactly how the legacy dicts behaved.

:class:`StatsView` is the compatibility seam: ``BlockExecutor.stats`` kept
its historical nested-dict shape for a dozen call sites (tests, benchmarks,
``shard_map.post_dispatch``), so the registry is fronted by a
``Mapping``-shaped view supporting the handful of mutation idioms those
sites use (``st["k"] += 1``, ``st["g"][b] = ...``, ``st["g"].setdefault(b,
{})``, ``dict(st)``) while every number lives in the registry exactly
once.

**Thread safety** (DESIGN.md §18): every metric carries a lock — metrics
created through a :class:`MetricsRegistry` all share the registry's single
re-entrant lock (``registry.lock``), so a whole-registry snapshot taken
under it is consistent against any concurrent mutation.  ``inc``/``set``/
``dec``/``observe`` are atomic; the legacy facade idioms (``st["k"] += 1``)
remain read-modify-write and are NOT safe under concurrency — hot paths
that run concurrently use :meth:`StatsView.inc` instead.
"""

from __future__ import annotations

import threading
from collections.abc import Mapping
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

Number = Union[int, float]

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView"]


class Counter:
    """Monotone-by-convention numeric metric with positional labels."""

    kind = "counter"

    def __init__(self, name: str, label_names: Tuple[str, ...] = (),
                 help: str = ""):
        self.name = name
        self.label_names = tuple(label_names)
        self.help = help
        #: value per label-value tuple (``()`` for an unlabeled metric);
        #: insertion order is the rendering order of views and snapshots
        self.values: Dict[Tuple, Number] = {}
        #: registry-created metrics share the registry's lock; a standalone
        #: metric gets a private one
        self.lock: "threading.RLock" = threading.RLock()

    def _check(self, labels: Tuple) -> Tuple:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name}: got {len(labels)} label values for "
                f"labels {self.label_names!r}")
        return labels

    def inc(self, amount: Number = 1, labels: Tuple = ()) -> None:
        labels = self._check(labels)
        with self.lock:
            self.values[labels] = self.values.get(labels, 0) + amount

    def set(self, value: Number, labels: Tuple = ()) -> None:
        labels = self._check(labels)
        with self.lock:
            self.values[labels] = value

    def get(self, labels: Tuple = (), default: Number = 0) -> Number:
        return self.values.get(labels, default)

    def clear(self) -> None:
        with self.lock:
            self.values.clear()


class Gauge(Counter):
    """A value that goes both ways (queue depths, high-water marks)."""

    kind = "gauge"

    def dec(self, amount: Number = 1, labels: Tuple = ()) -> None:
        self.inc(-amount, labels)


#: log-spaced default histogram buckets (seconds-ish scales)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class Histogram:
    """Bucketed distribution metric: count/sum/min/max plus cumulative
    bucket counts per label-value tuple."""

    kind = "histogram"

    def __init__(self, name: str, label_names: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 help: str = ""):
        self.name = name
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets))
        self.help = help
        # per label tuple: [count, sum, min, max, [bucket counts]]
        self.values: Dict[Tuple, List] = {}
        self.lock: "threading.RLock" = threading.RLock()

    def observe(self, value: Number, labels: Tuple = ()) -> None:
        if len(labels) != len(self.label_names):
            raise ValueError(f"{self.name}: bad labels {labels!r}")
        with self.lock:
            d = self.values.get(labels)
            if d is None:
                d = [0, 0.0, float("inf"), float("-inf"),
                     [0] * (len(self.buckets) + 1)]
                self.values[labels] = d
            d[0] += 1
            d[1] += value
            d[2] = min(d[2], value)
            d[3] = max(d[3], value)
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    d[4][i] += 1
                    break
            else:
                d[4][-1] += 1              # overflow bucket (> last edge)

    def summary(self, labels: Tuple = ()) -> Optional[Dict[str, Any]]:
        d = self.values.get(labels)
        if d is None:
            return None
        return {"count": d[0], "sum": d[1], "min": d[2], "max": d[3],
                "buckets": dict(zip([*map(str, self.buckets), "+inf"],
                                    d[4]))}

    def clear(self) -> None:
        with self.lock:
            self.values.clear()


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create store of named metrics.

    Re-requesting a name returns the existing metric (label names must
    match); requesting it as a different kind is an error — one name, one
    meaning, for the life of the process.

    Every metric created here shares the registry's re-entrant ``lock``:
    individual mutations are atomic without it, and holding it makes a
    multi-metric read (``snapshot``, ``StatsView.to_dict``) consistent
    against concurrent flushes — no increment is ever half-visible."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}
        #: one lock for the whole registry — shared by every metric in it
        self.lock: "threading.RLock" = threading.RLock()

    def _get_or_create(self, cls: type, name: str,
                       label_names: Tuple[str, ...], **kw: Any) -> Any:
        with self.lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, label_names, **kw)
                m.lock = self.lock
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or type(m) is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")  # type: ignore[attr-defined]
        if m.label_names != tuple(label_names):
            raise ValueError(f"metric {name!r} labels {m.label_names!r} "
                             f"!= requested {tuple(label_names)!r}")
        return m

    def counter(self, name: str, label_names: Tuple[str, ...] = (),
                help: str = "") -> Counter:
        return self._get_or_create(Counter, name, label_names, help=help)

    def gauge(self, name: str, label_names: Tuple[str, ...] = (),
              help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, label_names, help=help)

    def histogram(self, name: str, label_names: Tuple[str, ...] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  help: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, label_names,
                                   buckets=buckets, help=help)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Plain-data dump of every metric (JSON-serializable; label-value
        tuples render as comma-joined strings)."""
        out: Dict[str, Dict[str, Any]] = {}
        with self.lock:
            for name, m in self._metrics.items():
                if isinstance(m, Histogram):
                    vals: Dict[str, Any] = {
                        ",".join(map(str, k)): m.summary(k) for k in m.values}
                else:
                    vals = {",".join(map(str, k)): v
                            for k, v in m.values.items()}
                out[name] = {"kind": m.kind, "labels": list(m.label_names),
                             "values": vals}
        return out

    def clear_values(self) -> None:
        """Zero every metric, keeping registrations (observation reset)."""
        with self.lock:
            for m in self._metrics.values():
                m.clear()


# ---------------------------------------------------------------------------
# The legacy-dict facade
# ---------------------------------------------------------------------------

class LabelView(Mapping):
    """One nesting level of a labeled counter, shaped like the legacy
    ``stats["backend_blocks"]`` / ``stats["backend_fallbacks"][name]``
    sub-dicts: a live Mapping plus the mutation idioms those sites use."""

    def __init__(self, owner: "StatsView", group: str, base: Tuple):
        self._owner = owner
        self._group = group
        self._base = base

    def _counter(self) -> Counter:
        return self._owner._groups[self._group]

    def _leaf(self) -> bool:
        c = self._counter()
        return len(self._base) + 1 == len(c.label_names)

    def _level_keys(self) -> List[str]:
        """Label values at this level, insertion-ordered: declared keys
        first (the preset zero/empty shapes), then any that appeared."""
        k = len(self._base)
        out: Dict[str, None] = {}
        if k == 0:
            for d in self._owner._declared.get(self._group, ()):
                out[d] = None
        for labels in self._counter().values:
            if labels[:k] == self._base:
                out[labels[k]] = None
        return list(out)

    # -- Mapping protocol ----------------------------------------------
    def __iter__(self) -> Iterator[str]:
        return iter(self._level_keys())

    def __len__(self) -> int:
        return len(self._level_keys())

    def __getitem__(self, key: str):
        c = self._counter()
        if self._leaf():
            return c.values[self._base + (key,)]
        if key not in self._level_keys():
            raise KeyError(key)
        return LabelView(self._owner, self._group, self._base + (key,))

    # -- legacy mutation idioms ----------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        c = self._counter()
        if self._leaf():
            c.set(value, self._base + (key,))
            return
        # replace one nested level wholesale from a mapping
        prefix = self._base + (key,)
        for labels in [k for k in c.values if k[:len(prefix)] == prefix]:
            del c.values[labels]
        self._declare_key(key)
        for k2, v2 in dict(value).items():
            c.set(v2, prefix + (k2,))

    def _declare_key(self, key: str) -> None:
        if not self._base:
            self._owner._declared.setdefault(self._group, {})[key] = None

    def setdefault(self, key: str, default: Any = None):
        c = self._counter()
        if self._leaf():
            labels = self._base + (key,)
            if labels not in c.values:
                c.set(default, labels)
            return c.values[labels]
        self._declare_key(key)
        return LabelView(self._owner, self._group, self._base + (key,))

    def to_dict(self) -> Dict:
        return {k: (v.to_dict() if isinstance(v, LabelView) else v)
                for k, v in self.items()}

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Mapping):
            return self.to_dict() == _plain(other)
        return NotImplemented

    def __repr__(self) -> str:
        return repr(self.to_dict())


class StatsView(Mapping):
    """The legacy ``BlockExecutor.stats`` dict shape as a live view over a
    :class:`MetricsRegistry` — scalars are unlabeled counters, nested dicts
    are labeled counters, and every read/write goes straight through."""

    def __init__(self, registry: MetricsRegistry, prefix: str = "executor"):
        self._reg = registry
        self._prefix = prefix
        self._scalars: Dict[str, Counter] = {}
        self._groups: Dict[str, Counter] = {}
        #: declared first-level label values per group (preset shapes);
        #: ordered dict-as-set
        self._declared: Dict[str, Dict[str, None]] = {}
        self._order: Dict[str, None] = {}

    # -- shape declaration (executor reset) ----------------------------
    def declare_scalar(self, key: str, value: Number = 0) -> None:
        c = self._reg.counter(f"{self._prefix}.{key}")
        c.clear()
        c.set(value)
        self._scalars[key] = c
        self._order[key] = None

    def declare_group(self, key: str, label_names: Tuple[str, ...],
                      presets: Tuple[str, ...] = ()) -> None:
        c = self._reg.counter(f"{self._prefix}.{key}", label_names)
        c.clear()
        self._groups[key] = c
        self._declared[key] = {}
        for p in presets:
            self._declared[key][p] = None
            if len(label_names) == 1:
                c.set(0, (p,))
        self._order[key] = None

    def drop(self, key: str) -> None:
        """Forget a key entirely (shape reset between policies)."""
        self._scalars.pop(key, None)
        self._groups.pop(key, None)
        self._declared.pop(key, None)
        self._order.pop(key, None)

    # -- Mapping protocol ----------------------------------------------
    def __iter__(self) -> Iterator[str]:
        return iter(self._order)

    def __len__(self) -> int:
        return len(self._order)

    def __getitem__(self, key: str):
        c = self._scalars.get(key)
        if c is not None:
            return c.get()
        if key in self._groups:
            return LabelView(self, key, ())
        raise KeyError(key)

    # -- legacy mutation idioms ----------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if key in self._groups:
            c = self._groups[key]
            c.clear()
            self._declared[key] = {}
            for k2, v2 in dict(value).items():
                if isinstance(v2, Mapping):
                    LabelView(self, key, ())[k2] = v2
                else:
                    c.set(v2, (k2,))
                    self._declared[key][k2] = None
            return
        if key not in self._scalars:       # declare scalars on first write
            self.declare_scalar(key, 0)
        self._scalars[key].set(value)

    # -- atomic mutation (concurrent flush paths) -----------------------
    def inc(self, key: str, amount: Number = 1,
            labels: Tuple = ()) -> None:
        """Atomically add ``amount`` to a scalar (``labels=()``) or to one
        label-value of a declared group.  Unlike ``st[key] += 1`` — a
        read-modify-write that loses increments under concurrency — this
        lands on the metric's own ``inc`` and never drops a count."""
        if labels:
            self._groups[key].inc(amount, tuple(labels))
            return
        c = self._scalars.get(key)
        if c is None:
            with self._reg.lock:           # double-checked declaration
                c = self._scalars.get(key)
                if c is None:
                    self.declare_scalar(key, 0)
                    c = self._scalars[key]
        c.inc(amount)

    def to_dict(self) -> Dict:
        """Plain nested dicts — what ``snapshot_stats`` hands out."""
        return {k: (v.to_dict() if isinstance(v, LabelView) else v)
                for k, v in self.items()}

    def snapshot(self) -> Dict:
        """``to_dict`` under the registry lock: a point-in-time consistent
        copy even while other threads are mid-flush."""
        with self._reg.lock:
            return self.to_dict()

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Mapping):
            return self.to_dict() == _plain(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"StatsView({self.to_dict()!r})"


def _plain(m: Mapping) -> Dict:
    """Recursively materialize any Mapping (views included) as dicts."""
    return {k: (_plain(v) if isinstance(v, Mapping) else v)
            for k, v in m.items()}
