"""``paddle.distributed.sharding`` (counterpart:
``paddle_tpu/distributed/sharding``): the GroupSharded ZeRO levels with
host offload (``group_sharded.py``) and the per-block parameter-streaming
trainer (``param_stream.py``)."""

from .group_sharded import (LEVELS, build_sharded_train_step, gather_sharded,
                            group_sharded_parallel, param_specs,
                            save_group_sharded_model, shard_spec_for)
from .param_stream import (build_param_streamed_train_step, fetch, park,
                           supports_pinned_host)

__all__ = ["LEVELS", "build_sharded_train_step", "group_sharded_parallel",
           "param_specs", "save_group_sharded_model", "shard_spec_for",
           "gather_sharded", "build_param_streamed_train_step", "park",
           "fetch", "supports_pinned_host"]
