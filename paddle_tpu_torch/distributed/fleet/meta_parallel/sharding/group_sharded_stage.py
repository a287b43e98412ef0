"""GroupSharded stage-1/2/3 wrappers (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/sharding/
group_sharded_stage.py``; the reference's ``group_sharded_stage2.py:46``,
``group_sharded_stage3.py:85`` and ``group_sharded_optimizer_stage2.py:53``).

The wrappers keep the reference's class surface and carry the (mesh, axis,
level) that ``build_train_step`` hands to
``distributed.sharding.build_sharded_train_step``, where the gradient
reduce-scatter, the parameter gathers and the offload live. Sharding a
layer's ``Parameter``s in place (stage 3's ``_shard_parameters`` over a
layer that has parameters) needs ``Parameter`` and raises NotImplementedError
naming ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

__all__ = ["GroupShardedStage1", "GroupShardedStage2", "GroupShardedStage3",
           "GroupShardedOptimizerStage2"]


class GroupShardedOptimizerStage2:
    """Optimizer wrapper: sharded slots (``DygraphShardingOptimizer``); the
    gradient reduce-scatter is the train step's."""

    def __init__(self, params=None, optim=None, group=None, mesh=None,
                 axis: str = "sharding", offload: bool = False, **unused):
        del unused, offload
        from .dygraph_sharding_optimizer import DygraphShardingOptimizer
        self._impl = DygraphShardingOptimizer(
            optim, hcg=None, mesh=mesh or getattr(group, "mesh", None),
            axis=axis)
        self._params = params

    def __getattr__(self, name):
        return getattr(self._impl, name)


class _ShardedModelBase:
    stage = 0

    def __init__(self, layer, optimizer=None, group=None, mesh=None,
                 axis: str = "sharding", sync_buffers: bool = False,
                 offload: bool = False, **unused):
        del unused, sync_buffers
        self._layer = layer
        self._optimizer = optimizer
        self._mesh = mesh or getattr(group, "mesh", None)
        self._axis = axis
        self._offload = offload
        if self.stage >= 3 and self._mesh is not None:
            self._shard_parameters()

    def _shard_parameters(self):
        params = (list(self._layer.parameters())
                  if hasattr(self._layer, "parameters") else [])
        if params:
            raise NotImplementedError(
                "sharding a layer's Parameters in place is not ported yet "
                "(ROADMAP Queue 1 item 10: Parameter); train its parameter "
                "tree through build_train_step")

    def __getattr__(self, name):
        return getattr(self._layer, name)

    def __call__(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layer(*args, **kwargs)

    def build_train_step(self, loss_fn, data_axes=("dp", "sharding")):
        """The functional ZeRO train step for this wrapper's level:
        ``(step, place, compile_for)`` of ``build_sharded_train_step``."""
        from ....sharding.group_sharded import build_sharded_train_step
        level = {1: "os", 2: "os_g", 3: "p_g_os"}[self.stage]
        return build_sharded_train_step(
            loss_fn, self._optimizer, self._mesh, level=level,
            data_axes=data_axes, shard_axis=self._axis,
            offload=self._offload)


class GroupShardedStage1(_ShardedModelBase):
    """Stage 1 (optimizer state only); the reference reaches it through
    ``DygraphShardingOptimizer`` alone, fleet keeps a wrapper."""
    stage = 1


class GroupShardedStage2(_ShardedModelBase):
    stage = 2


class GroupShardedStage3(_ShardedModelBase):
    stage = 3
