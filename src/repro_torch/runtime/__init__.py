"""Step-level fault tolerance: the port of ``repro/runtime`` (the
elastic re-mesh waits for the mesh, ROADMAP A10b)."""

from .fault import FaultTolerantLoop, StragglerWatchdog       # noqa: F401
