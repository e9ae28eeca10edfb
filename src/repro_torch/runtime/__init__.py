"""Step-level fault tolerance and the elastic re-mesh
(``elastic.reshard_params``): the port of ``repro/runtime``."""

from .fault import FaultTolerantLoop, StragglerWatchdog       # noqa: F401
