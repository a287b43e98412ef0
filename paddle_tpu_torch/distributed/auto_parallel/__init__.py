"""Semi-auto parallel (counterpart: ``paddle_tpu/distributed/auto_parallel``).
Only the sharding-stage part of ``api.py`` is ported: ``ShardingStage1/2/3``
and ``shard_optimizer``. The DistTensor API (``shard_tensor``, ``reshard``,
``shard_layer``, the dtensor functions, ``ProcessMesh`` and the
placements) is ROADMAP Queue 1 item 10 and raises NotImplementedError."""

from .api import (ShardingStage1, ShardingStage2, ShardingStage3,
                  dtensor_from_local, dtensor_to_local, get_placements,
                  reshard, shard_layer, shard_optimizer, shard_tensor,
                  unshard_dtensor)

__all__ = ["shard_tensor", "reshard", "shard_layer", "dtensor_from_local",
           "dtensor_to_local", "unshard_dtensor", "shard_optimizer",
           "get_placements", "ShardingStage1", "ShardingStage2",
           "ShardingStage3"]
