"""Fleet's meta-parallel stack (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel``): the sharding wrappers
only; the tensor- and pipeline-parallel layers are ROADMAP Queue 1 item
6."""

from .sharding import (DygraphShardingOptimizer, GroupShardedOptimizerStage2,
                       GroupShardedStage1, GroupShardedStage2,
                       GroupShardedStage3)

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage1", "GroupShardedStage2", "GroupShardedStage3"]
