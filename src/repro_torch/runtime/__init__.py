"""Step-level fault tolerance: the port of ``repro/runtime`` (the
elastic re-mesh waits for the model on the mesh, ROADMAP A10b-iii)."""

from .fault import FaultTolerantLoop, StragglerWatchdog       # noqa: F401
