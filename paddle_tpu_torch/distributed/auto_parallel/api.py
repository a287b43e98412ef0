"""ZeRO through ``shard_optimizer`` (counterpart:
``paddle_tpu/distributed/auto_parallel/api.py`` ``ShardingStage1/2/3``,
``_ShardedOptimizer`` and ``shard_optimizer``; the reference's
``api.py:1448`` and its stage shard_fns).

The JAX wrapper annotates the optimizer state with shardings and leaves
the partition to GSPMD. Here ``init_state`` gives this rank its own slice
of every slot tensor (along ``shard_spec_for``'s dim, a contiguous tensor
of its own; parked in pinned host memory with ``offload=True``), and
``apply`` takes the full (already synchronized) gradients and updates this
rank's slices: the clip runs on the full gradients, each sharded leaf's
slice of the parameter is updated with its slice of the gradient and the
slices are all-gathered back into the full parameter.

Not ported, each raising NotImplementedError that names ROADMAP Queue 1
item 10 (the DistTensor API and ``Parameter``): ``shard_tensor``,
``reshard``, ``shard_layer``, ``dtensor_from_local``, ``dtensor_to_local``,
``unshard_dtensor``, ``get_placements``, and stage 3's in-place sharding of
an optimizer's parameter list.
"""

from __future__ import annotations

from typing import Union

import torch

from ...enforce import PreconditionNotMetError, enforce
from .. import _tree
from .. import collective as C

__all__ = ["shard_tensor", "reshard", "shard_layer", "dtensor_from_local",
           "dtensor_to_local", "unshard_dtensor", "shard_optimizer",
           "get_placements", "ShardingStage1", "ShardingStage2",
           "ShardingStage3"]


def _item10(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item 10: the DistTensor API and Parameter)")


def shard_tensor(*args, **kwargs):
    raise _item10("shard_tensor")


def reshard(*args, **kwargs):
    raise _item10("reshard")


def shard_layer(*args, **kwargs):
    raise _item10("shard_layer")


def dtensor_from_local(*args, **kwargs):
    raise _item10("dtensor_from_local")


def dtensor_to_local(*args, **kwargs):
    raise _item10("dtensor_to_local")


def unshard_dtensor(*args, **kwargs):
    raise _item10("unshard_dtensor")


def get_placements(*args, **kwargs):
    raise _item10("get_placements")


class _ShardingStageBase:
    def __init__(self, mesh=None, sharding_mesh_dim: Union[int, str, None]
                 = None):
        self._mesh = mesh
        self._dim = sharding_mesh_dim


class ShardingStage1(_ShardingStageBase):
    """Shard the optimizer state (the moments) along the sharding axis."""
    stage = 1


class ShardingStage2(_ShardingStageBase):
    """Optimizer state and gradients sharded (the gradient reduce-scatter
    is the train step's, ``build_sharded_train_step``)."""
    stage = 2


class ShardingStage3(_ShardingStageBase):
    """Parameters sharded too (``build_sharded_train_step`` level
    p_g_os)."""
    stage = 3


class _ShardedOptimizer:
    """Wraps an optimizer so ``init_state`` gives this rank's slot shards
    and ``apply`` updates them (ZeRO-1 over full gradients)."""

    def __init__(self, optimizer, shard_cfg, mesh, offload=False):
        self._inner = optimizer
        self._cfg = shard_cfg
        self._mesh = mesh
        self._offload = offload
        self._full_like = None      # the parameters' shapes, at init_state
        self._copier = None
        if offload:
            from ..sharding._host import Copier
            self._copier = Copier(mesh.device if mesh.device is not None
                                  else torch.device("cpu"))

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _shard_axis_name(self):
        dim = self._cfg._dim
        if isinstance(dim, str):
            return dim
        names = self._mesh.axis_names
        if dim is None:
            for cand in ("sharding", "dp"):
                if cand in names:
                    return cand
            return names[0]
        return names[dim]

    def _dim(self, leaf) -> int:
        from ..sharding.group_sharded import _dim_of, shard_spec_for
        axis = self._shard_axis_name()
        return _dim_of(shard_spec_for(leaf, self._mesh, axis), axis)

    def _layout(self):
        axis = self._shard_axis_name()
        return (int(self._mesh.shape[axis]), self._mesh.axis_index(axis),
                self._mesh.group(axis))

    def _shard_leaf(self, leaf):
        from ..sharding.group_sharded import _shard
        n, idx, _ = self._layout()
        return _shard(leaf, self._dim(leaf), idx, n)

    def _park(self, slot):
        if not self._offload:
            return slot
        host = self._copier.park_new(
            slot,
            keep=lambda t: not isinstance(t, torch.Tensor) or t.dim() == 0)
        self._copier.drain()
        return host

    def init_state(self, params):
        from ..sharding.group_sharded import _meta
        self._full_like = _tree.tree_map(_meta, params)
        state = self._inner.init_state(params)
        paths = [p for p, _ in _tree.flatten(params)]
        slots = []
        for path in paths:
            slot = _lookup(state["slots"], path)
            slots.append(self._park({k: self._shard_leaf(v)
                                     for k, v in slot.items()}))
        state["slots"] = _tree.unflatten(paths, slots)
        return state

    @torch.no_grad()
    def apply(self, params, grads, state, lr=None):
        from ...kernels.fused_adam import shard_window
        from ..sharding.group_sharded import _shard
        opt = self._inner
        lr = opt.get_lr() if lr is None else float(lr)
        step = int(state["step"]) + 1
        if opt._grad_clip is not None:
            grads = opt._grad_clip(grads)
        n, idx, group = self._layout()
        gathers = []
        for (path, _), (p, g, s, ctx, seed) in zip(
                _tree.flatten(params),
                opt._leaf_items(params, grads, state["slots"], step)):
            if g is None:
                continue
            host = s
            if self._offload:
                s = self._copier.fetch(s).get()
            d = self._dim(p)
            if d < 0 or n == 1:
                opt._update_ctx(ctx, p, g, s, lr, step, seed=seed)
            else:
                p_sh = _shard(p, d, idx, n)
                per = p.shape[d] // n
                opt._update_ctx(ctx, p_sh, _shard(g, d, idx, n), s, lr, step,
                                seed=shard_window(seed, d, idx * per,
                                                  p.shape[d]))
                gathers.append((p, C.all_gather_into(p_sh, d, group,
                                                     sync_op=False)))
            if self._offload:
                self._copier.park(s, host)
        for p, w in gathers:
            p.copy_(w.wait())
        if self._offload:
            self._copier.drain()
        state["step"] = step
        return params, state

    def _full_state(self, state):
        """The state with every slot shard all-gathered to its full shape
        (on the device; every rank of the axis calls this)."""
        from ..sharding.group_sharded import gather_sharded
        enforce(self._full_like is not None, "init_state() first",
                op="_ShardedOptimizer._full_state",
                error=PreconditionNotMetError)
        slots = state["slots"]
        if self._offload:
            paths = [p for p, _ in _tree.flatten(self._full_like)]
            slots = _tree.unflatten(paths, [
                self._copier.fetch(_lookup(slots, p)).get() for p in paths])
        return {"step": state["step"],
                "slots": gather_sharded(slots, self._full_like, self._mesh,
                                        self._shard_axis_name())}

    def step(self):
        return self._inner.step()

    def clear_grad(self):
        return self._inner.clear_grad()


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def shard_optimizer(optimizer, shard_fn=None, mesh=None, offload=False):
    """(the reference's ``api.py:1448``) With a ``ShardingStage*``
    ``shard_fn`` the optimizer state is sharded over the mesh axis;
    ``offload=True`` parks it in host memory between steps."""
    if shard_fn is None:
        shard_fn = ShardingStage1(mesh)
    use_mesh = mesh if mesh is not None else getattr(shard_fn, "_mesh", None)
    enforce(use_mesh is not None, "shard_optimizer needs a mesh",
            op="shard_optimizer", error=PreconditionNotMetError)
    if getattr(shard_fn, "stage", 1) >= 3 and getattr(
            optimizer, "_parameter_list", None):
        raise _item10("stage 3's in-place sharding of the optimizer's "
                      "parameter list")
    return _ShardedOptimizer(optimizer, shard_fn, use_mesh, offload=offload)
