from .sharding import (RULES_SERVE, RULES_TRAIN, PartitionSpec,     # noqa
                       batch_spec, logical_to_mesh, params_specs, shard_tree)
