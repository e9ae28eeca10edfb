# The paper's primary contribution — runtime fusion of array operations via
# Weighted Subroutine Partition (WSP) graph partitioning — ported to PyTorch
# with hand-written Triton kernels for an NVIDIA H100.  Module for module a
# counterpart of ``repro.core``; see ROADMAP.md for what is ported so far.
from .ir import BaseArray, COMM_OPS, Op, View                    # noqa: F401
from .fusion import (WSPGraph, build_graph,                      # noqa: F401
                     build_graph_reference, fusible, depends)
from .blocks import BlockInfo                                    # noqa: F401
from .cost import (BohriumCost, CalibratedCost, CostModel,       # noqa: F401
                   GPUCost, MaxContractCost, MaxLocalityCost,
                   RobinsonCost, closed_form_saving, make_cost_model,
                   model_cache_token)
from .partition import PartitionState                            # noqa: F401
from .algorithms import PartitionResult, partition               # noqa: F401
from .cache import MergeCache, tape_signature                    # noqa: F401
from .backends import (LoweringBackend, LoweringContext,         # noqa: F401
                       LoweringDecision, LoweringPolicy,
                       available_backends, get_backend,
                       register_backend, select_lowering)
from .executor import BlockExecutor, make_block_fn, block_io     # noqa: F401
from .scheduler import BlockPlan, Schedule, Scheduler, plan_blocks  # noqa: F401
from . import lazy                                               # noqa: F401
from . import tuning                                             # noqa: F401
