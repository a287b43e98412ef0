from .dygraph_sharding_optimizer import DygraphShardingOptimizer
from .group_sharded_stage import (GroupShardedOptimizerStage2,
                                  GroupShardedStage1, GroupShardedStage2,
                                  GroupShardedStage3)

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage1", "GroupShardedStage2", "GroupShardedStage3"]
