"""Stage-1 sharding optimizer for the hybrid-parallel stack (counterpart:
``paddle_tpu/distributed/fleet/meta_parallel/sharding/
dygraph_sharding_optimizer.py``; the reference's
``dygraph_sharding_optimizer.py:44``: ``reduce_gradients`` (:310) and
``_sharding_sync_parameters`` (:363)).

The functional surface: ``shard_state_specs``, ``init_state`` (this rank's
slot shards along ``shard_spec_for``'s dim), ``apply`` (the ZeRO-1 update
of ``shard_optimizer``'s wrapper: full gradients in, this rank's slices
updated, the parameters all-gathered), ``reduce_gradients`` (an AVG
all-reduce over the axis group) and ``_sharding_sync_parameters`` (the
owner's broadcast: rank 0 of the axis group sends every leaf).

Not ported: the rank partition over an optimizer's ``_parameter_list``
(``_partition_parameters``, ``param_to_rank``), which needs ``Parameter``
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

from .... import _tree
from .... import collective as C

__all__ = ["DygraphShardingOptimizer"]


def _item10(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item 10: Parameter)")


class DygraphShardingOptimizer:
    def __init__(self, optimizer, hcg=None, mesh=None, axis: str = "sharding"):
        self._inner_opt = optimizer
        self._hcg = hcg
        if mesh is None and hcg is not None:
            mesh = hcg.mesh
        self._mesh = mesh
        self._axis = axis
        self._degree = (int(mesh.shape[axis]) if mesh is not None
                        and axis in mesh.shape else 1)
        self._rank = (mesh.axis_index(axis) if self._degree > 1 else 0)
        self._sharded = None
        if self._degree > 1:
            from ....auto_parallel.api import ShardingStage1, shard_optimizer
            self._sharded = shard_optimizer(
                optimizer, ShardingStage1(mesh, axis), mesh)

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    # -- the reference's bookkeeping over Parameters -------------------------
    def _partition_parameters(self):
        raise _item10("the rank partition of the optimizer's parameter list")

    @property
    def param_to_rank(self):
        raise _item10("param_to_rank over the optimizer's parameter list")

    # -- the functional surface ----------------------------------------------
    def shard_state_specs(self, params):
        """The slot shardings, as specs (tuples of axis names or None)."""
        from ....sharding.group_sharded import _state_specs
        return _state_specs(self._inner_opt, params, self._mesh, self._axis)

    def init_state(self, params):
        if self._sharded is None:
            return self._inner_opt.init_state(params)
        return self._sharded.init_state(params)

    def apply(self, params, grads, state, lr=None):
        if self._sharded is None:
            return self._inner_opt.apply(params, grads, state, lr)
        return self._sharded.apply(params, grads, state, lr)

    def reduce_gradients(self, grads, axis: Optional[str] = None):
        """The gradients averaged over the axis group (new tensors)."""
        group = self._mesh.group(axis or self._axis)
        return _tree.tree_map(
            lambda g: None if g is None else C.all_reduce(
                g.clone(), C.ReduceOp.AVG, group), grads)

    def _sharding_sync_parameters(self, params):
        """Every leaf broadcast from rank 0 of the axis group, in place (the
        reference's owner broadcast; ``apply`` already leaves the ranks'
        copies equal, so this only re-asserts it)."""
        if self._mesh is None or self._degree == 1:
            return params
        group = self._mesh.group(self._axis)
        for _, p in _tree.flatten(params):
            C.broadcast(p, src=group.ranks[0], group=group)
        return params

    # -- eager passthrough ---------------------------------------------------
    def step(self):
        return self._inner_opt.step()

    def clear_grad(self):
        return self._inner_opt.clear_grad()
