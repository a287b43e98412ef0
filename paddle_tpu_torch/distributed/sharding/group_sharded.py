"""GroupSharded (ZeRO) data-parallel training (counterpart:
``paddle_tpu/distributed/sharding/group_sharded.py``: ``LEVELS``,
``_leaf_streamable``, ``shard_spec_for``, ``param_specs``, ``_state_specs``,
``build_sharded_train_step``, ``group_sharded_parallel`` and
``save_group_sharded_model``; the reference's ``group_sharded_parallel``
levels os / os_g / p_g_os and the stage-3 offload).

The JAX step is one program over GLOBAL arrays whose collectives XLA
derives from the shardings. Here every rank is a process that holds its
own shards, runs ``loss_fn`` on its slice of the batch and meets the others
in ``torch.distributed`` collectives, so that the step's numbers are the
JAX step's:

* gradients are averaged over the data axes: an all-reduce over each data
  axis but the shard axis, then over the shard axis an all-reduce at stage
  1 (os) and a reduce-scatter to the leaf's ``shard_spec_for`` dim at
  stages 2 and 3 (os_g, p_g_os);
* each rank updates its own slice of the optimizer state (and of the
  parameters), and at stages 1 and 2 the new slices are all-gathered back
  into the full parameters;
* at stage 3 the parameters live as shards; ``loss_fn`` takes the whole
  tree, so the shards are gathered on entry (``comm_overlap.zero3``
  ``gather_group``, whose backward is the reduce-scatter) and the gathered
  copy is freed once the backward is done;
* the optimizer's clip acts on the global gradients: a global norm counts
  each element once across ranks (``hybrid_engine._global_clip_scale``);
* the step returns the global mean loss.

A leaf's shard is its own contiguous tensor (a shard along a dim other than
the first is a strided slice of the full leaf). A shard's update draws the
stochastic-rounding noise that its elements draw in the whole leaf's update
(``kernels.fused_adam.shard_window``), as the JAX step rounds the global
leaf: the moments do not depend on the number of shards.

``offload=True`` keeps this rank's optimizer state in host memory (pinned on
the card). ``place`` builds the slots one leaf at a time and parks each
before the next exists. A step runs one gradient pass (with the clip and
the stage's reduction), parks the gradients, then updates leaf by leaf:
fetch the leaf's gradient and slot, update, park the new slot back into the
same host buffers; the next leaf's fetch is issued before the current
update. The numbers are bit for bit those of ``offload=False``: offload only
moves bytes.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ...enforce import PreconditionNotMetError, enforce, enforce_in
from ...kernels.fused_adam import shard_window
from .. import _tree
from .. import collective as C

__all__ = [
    "LEVELS", "shard_spec_for", "param_specs", "build_sharded_train_step",
    "group_sharded_parallel", "save_group_sharded_model", "gather_sharded",
]

LEVELS = ("os", "os_g", "p_g_os")
_STAGE_OF = {"os": 1, "os_g": 2, "p_g_os": 3}


def _leaf_streamable(optimizer) -> bool:
    """True when the offload path may run the optimizer's update as a
    per-leaf loop: it has ``_init_slot`` and the base ``Optimizer.apply``
    (the port's Adam / AdamW; a name filter streams too, the loop threads
    full-tree names). An optimizer with an ``apply`` of its own runs it."""
    from ...optimizer.optimizer import Optimizer
    if not hasattr(optimizer, "_init_slot"):
        return False
    return type(optimizer).apply is Optimizer.apply


def _unwrap(optimizer):
    """The optimizer under the port's sharding wrappers (``shard_optimizer``,
    ``DygraphShardingOptimizer``, ``GroupShardedOptimizerStage2``): the
    step shards and offloads the state itself, so their ``apply`` would
    only do it twice."""
    from ..auto_parallel.api import _ShardedOptimizer
    from ..fleet.meta_parallel.sharding.dygraph_sharding_optimizer import \
        DygraphShardingOptimizer
    from ..fleet.meta_parallel.sharding.group_sharded_stage import \
        GroupShardedOptimizerStage2
    while True:
        if isinstance(optimizer, _ShardedOptimizer):
            optimizer = optimizer._inner
        elif isinstance(optimizer, GroupShardedOptimizerStage2):
            optimizer = optimizer._impl
        elif isinstance(optimizer, DygraphShardingOptimizer):
            optimizer = optimizer._inner_opt
        else:
            return optimizer


def shard_spec_for(leaf, mesh, axis: str) -> tuple:
    """Spec sharding ``leaf`` along its largest dim divisible by the axis
    size (the first such dim among equals); replicated (all None) if none
    is. ``mesh`` needs only ``shape`` (``{axis: degree}``)."""
    size = int(mesh.shape[axis])
    shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
    entries = [None] * len(shape)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % size == 0 and shape[d] >= size:
            entries[d] = axis
            break
    return tuple(entries)


def _dim_of(spec, axis) -> int:
    return spec.index(axis) if axis in spec else -1


def param_specs(params, mesh, axis: str, stage: int):
    """Parameter specs for a ZeRO stage: sharded at stage 3, replicated
    below."""
    if stage >= 3:
        return _tree.tree_map(lambda p: shard_spec_for(p, mesh, axis), params)
    return _tree.tree_map(lambda p: (), params)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    from ...models.convert import tensor_from_numpy
    a = np.asarray(x)
    dtype = tensor_from_numpy(np.empty((0,), a.dtype), "cpu").dtype
    return torch.empty(a.shape, dtype=dtype, device="meta")


def _state_specs(optimizer, params, mesh, axis: str):
    """Optimizer-state specs: every slot tensor sharded like its
    parameter's sharded form (the ZeRO-1 partition), the step replicated."""
    state = optimizer.init_state(_tree.tree_map(_meta, params))
    return {"step": (),
            "slots": _tree.tree_map(lambda s: shard_spec_for(s, mesh, axis),
                                    state["slots"])}


def _shard(x, dim: int, idx: int, n: int):
    """Rank ``idx``'s block of ``x`` along ``dim`` of ``n`` as a contiguous
    tensor (``x`` itself when ``dim < 0`` or ``n == 1``)."""
    if dim < 0 or n == 1:
        return x
    per = x.shape[dim] // n
    return x.narrow(dim, idx * per, per).contiguous()


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    from ...models.convert import tensor_from_numpy
    return tensor_from_numpy(x, device)


def _clone_tree(tree, pinned):
    """A copy of a (device or host) state tree; host Segments get new host
    buffers of the same layout."""
    from ._host import Segment
    if isinstance(tree, Segment):
        seg = tree.like(pinned)
        seg.buffer.copy_(tree.buffer)
        return seg
    if isinstance(tree, dict):
        return {k: _clone_tree(v, pinned) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def gather_sharded(tree, full_like, mesh, axis: str = "sharding"):
    """The full tensors of a tree of this rank's shards: each leaf of
    ``tree`` that ``shard_spec_for(full_like leaf)`` shards is all-gathered
    over ``axis`` (every rank of the axis calls this). ``full_like`` gives
    the full shapes (tensors, numpy arrays or meta tensors); a slot tree
    may pass the parameter tree, its slot dicts are matched leaf by leaf."""
    group = mesh.group(axis)
    n = int(mesh.shape[axis])
    shapes = dict(_tree.flatten(full_like))

    def full_shape(path):
        for k in range(len(path), 0, -1):
            if path[:k] in shapes:
                return tuple(getattr(shapes[path[:k]], "shape", ()))
        raise KeyError(path)

    out = []
    pairs = _tree.flatten(tree)
    for path, t in pairs:
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            out.append(t)
            continue
        shape = full_shape(path)
        d = _dim_of(shard_spec_for(torch.empty(shape, device="meta"),
                                   mesh, axis), axis) \
            if len(shape) == t.dim() else -1
        if d < 0 or n == 1 or tuple(t.shape) == shape:
            out.append(t)
        else:
            out.append(C.all_gather_into(t.contiguous(), d, group))
    return _tree.unflatten([p for p, _ in pairs], out)


def build_sharded_train_step(
    loss_fn: Callable, optimizer, mesh, level: str = "p_g_os",
    data_axes: Union[str, Sequence[str]] = ("dp", "sharding"),
    shard_axis: str = "sharding", donate: bool = True,
    offload: bool = False, microbatches: Optional[int] = None,
):
    """A ZeRO train step. ``loss_fn(params, *batch) -> scalar`` is written
    for the whole tree and a batch, and must be a mean over the batch: each
    rank runs it on its slice and the step averages over the data axes.

    Returns ``(step, place, compile_for)``:

    * ``step(params, opt_state, *batch, lr)``: the update without offload;
    * ``place(params)`` -> ``(params, opt_state)``: the global tree
      (tensors or numpy arrays) as this rank's tree on its device (full
      leaves, or at stage 3 the shards of the shardable leaves) and this
      rank's optimizer state (slot shards; parked on the host with
      ``offload=True``);
    * ``compile_for(placed_params)`` -> ``(step, batch_spec)``: the step
      to call (the offload step with ``offload=True``) and the batch's
      spec, ``(data_axes,)``: cut each batch array with
      ``distributed.shard_batch(x, mesh, batch_spec[0])`` before the call.

    The step returns ``(params, opt_state, loss)`` with ``loss`` the global
    mean. ``microbatches > 1`` (None reads ``FLAGS_comm_overlap_
    microbatches``) accumulates the slices' reduced gradients in fp32
    (``comm_overlap.microbatched_reduced_grads``). ``donate=False`` leaves
    the caller's trees as they were."""
    from ...models import hybrid_engine as HE
    from ...nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                            ClipGradByValue)
    from ...optimizer.optimizer import Optimizer
    from ..comm_overlap import microbatched_reduced_grads
    from ..comm_overlap.overlap import Done, Pending
    from ..comm_overlap.zero3 import gather_group
    from ._host import Copier

    enforce_in(level, LEVELS, op="build_sharded_train_step", name="level")
    stage = _STAGE_OF[level]
    if microbatches is None:
        from ...flags import flag
        microbatches = max(int(flag("comm_overlap_microbatches")), 1)
    microbatches = int(microbatches)
    enforce(microbatches == 1 or not offload,
            "offload streams the update per leaf from its own grad "
            "program; compose gradient accumulation there via "
            "GradientMergeOptimizer instead of scan microbatches",
            op="build_sharded_train_step", error=PreconditionNotMetError)
    enforce_in(shard_axis, mesh.shape,
               f"mesh has no axis '{shard_axis}': {mesh.shape}",
               op="build_sharded_train_step")
    if isinstance(data_axes, str):
        data_axes = (data_axes,)
    data_axes = tuple(a for a in data_axes if a in mesh.shape
                      and mesh.shape[a] > 1) or (shard_axis,)
    opt = _unwrap(optimizer)
    streamable = _leaf_streamable(opt)
    per_leaf_init = (hasattr(opt, "_init_slot")
                     and type(opt).init_state is Optimizer.init_state)
    clip, _ = HE._effective_clip(opt)
    n = int(mesh.shape[shard_axis])
    idx = mesh.axis_index(shard_axis)
    sgroup = mesh.group(shard_axis)
    others = [a for a in data_axes if a != shard_axis]
    shard_in_data = shard_axis in data_axes
    n_data = math.prod(int(mesh.shape[a]) for a in data_axes)
    device = mesh.device
    pinned = device.type == "cuda"
    copier = Copier(device) if offload else None
    plan = {}       # "dims": {path: shard dim or -1}, from the full shapes

    def _dims(params):
        if "dims" not in plan:
            enforce(stage < 3, "stage 3 needs place() first (its parameters "
                    "are shards: the full shapes pick the shard dims)",
                    op="build_sharded_train_step")
            plan["dims"] = {path: _dim_of(shard_spec_for(p, mesh, shard_axis),
                                          shard_axis)
                            for path, p in _tree.flatten(params)}
        return plan["dims"]

    def _offloadable(t):
        # scalars (a step counter) stay on the device
        return isinstance(t, torch.Tensor) and t.dim() >= 1

    def _park_slot(slot):
        host = copier.park_new(slot, keep=lambda t: not _offloadable(t))
        copier.drain()
        return host

    # -- place ----------------------------------------------------------------
    def place(params):
        full = _tree.tree_map(lambda v: _as_tensor(v, device).contiguous(),
                              params)
        plan["dims"] = {path: _dim_of(shard_spec_for(p, mesh, shard_axis),
                                      shard_axis)
                        for path, p in _tree.flatten(full)}
        dims = plan["dims"]
        pairs = _tree.flatten(full)
        paths = [p for p, _ in pairs]
        shards = [_shard(t, dims[p], idx, n) for p, t in pairs]
        local = (_tree.unflatten(paths, shards) if stage >= 3 else full)
        if offload and per_leaf_init:
            # one leaf's slots at a time, each parked before the next
            # exists: a whole-tree init would hold every moment on the
            # device at once, the spike offload exists to avoid
            slots = [_park_slot(opt._init_slot(s)) for s in shards]
            return local, {"step": 0,
                           "slots": _tree.unflatten(paths, slots)}
        # an optimizer with its own state layout: the whole-tree init
        state = opt.init_state(_tree.unflatten(paths, shards))
        if offload:
            state["slots"] = _tree.unflatten(paths, [
                _park_slot(s) for _, s in _flatten_slots(state["slots"],
                                                         paths)])
        return local, state

    # -- the gradient pass ----------------------------------------------------
    def _local_loss(params, *batch):
        if stage >= 3:
            params = _gathered(params)
        return loss_fn(params, *batch)

    def _gathered(params):
        """The full tree from this rank's shards: the sharded leaves of
        each dtype in one all-gather whose backward reduce-scatters."""
        dims = plan["dims"]
        pairs = _tree.flatten(params)
        vals = [t for _, t in pairs]
        groups = {}
        for i, (path, t) in enumerate(pairs):
            if dims[path] >= 0:
                groups.setdefault(t.dtype, []).append(i)
        for ids in groups.values():
            fulls = gather_group([vals[i] for i in ids],
                                 [dims[pairs[i][0]] for i in ids], sgroup)
            for i, f in zip(ids, fulls):
                vals[i] = f
        return _tree.unflatten([p for p, _ in pairs], vals)

    def _reduce_leaf(path, g, weight):
        """This rank's part of the data-axes mean of one gradient leaf: its
        shard at stages 2 and 3 (a shardable leaf), the full leaf else."""
        if g is None:
            return Done(None)
        dt = g.dtype
        if weight != 1.0:
            g = g * torch.tensor(weight, dtype=dt)
        for a in others:
            g = C.all_reduce(g.contiguous(), C.ReduceOp.SUM, mesh.group(a))
        d = plan["dims"][path]
        if stage >= 3 and d >= 0:
            # summed over the shard axis already, by the gather's backward
            den = n_data if shard_in_data else n_data * n
            return Done((g / den).to(dt))
        if not shard_in_data:
            g = _shard(g, d, idx, n) if stage >= 2 else g
            return Done((g / n_data).to(dt))
        if stage >= 2 and d >= 0:
            w = C.reduce_scatter_into(g, d, sgroup, sync_op=False)
        else:
            w = C.all_reduce(g.contiguous(), C.ReduceOp.SUM, sgroup,
                             sync_op=False)
        return C.Work(None, lambda: (w.wait() / n_data).to(dt))

    def _reduce_tree(grads, weight):
        pairs = _tree.flatten(grads)
        works = [_reduce_leaf(p, g, weight) for p, g in pairs]
        return Pending(works, lambda vals: _tree.unflatten(
            [p for p, _ in pairs], vals))

    def _global_loss(loss):
        acc = loss.detach().reshape(1).clone()
        for a in data_axes:
            C.all_reduce(acc, C.ReduceOp.SUM, mesh.group(a))
        return (acc / n_data)[0]

    def _clip(grads):
        """The optimizer's clip over the global gradients (this rank's
        layout in, the same layout out)."""
        if clip is None:
            return grads
        dims = plan["dims"]
        pairs = _tree.flatten(grads)
        sharded = [stage >= 2 and dims[p] >= 0 for p, _ in pairs]
        if not any(sharded) or n == 1:
            return clip(grads)       # every leaf whole: the clip's own call
        if isinstance(clip, ClipGradByValue):
            return clip(grads)
        red = [g for _, g in pairs]
        if isinstance(clip, ClipGradByGlobalNorm):
            specs = [((shard_axis,) if s else ()) for s in sharded]
            scale = HE._global_clip_scale(red, specs, [-1] * len(red), mesh,
                                          shard_axis, clip)
            out = [None if g is None else (g * scale).to(g.dtype)
                   for g in red]
        elif isinstance(clip, ClipGradByNorm):
            out = []
            for g, s in zip(red, sharded):
                if g is None:
                    out.append(None)
                    continue
                n2 = torch.sum(torch.square(g.float())).reshape(1)
                if s:
                    n2 = C.all_reduce(n2, C.ReduceOp.SUM, sgroup)
                norm = torch.sqrt(n2[0])
                sc = torch.clamp(clip.clip_norm / torch.clamp(norm, min=1e-12),
                                 max=1.0)
                out.append((g * sc).to(g.dtype))
        else:
            raise NotImplementedError(
                f"{type(clip).__name__} over gradients sharded at stage "
                f"{stage}: the step clips by global norm, by norm or by "
                f"value")
        return _tree.unflatten([p for p, _ in pairs], out)

    def _grad_pass(params, batch):
        """(global mean loss, reduced and clipped gradients in this rank's
        layout)."""
        _dims(params)
        loss, grads, _ = microbatched_reduced_grads(
            _local_loss, params, batch, microbatches,
            lambda g, res: (_reduce_tree(g, 1.0 / microbatches), res))
        return _global_loss(loss), _clip(grads)

    # -- the update -----------------------------------------------------------
    def _update_leaf(path, p, g, s, ctx, seed, lr, step_no, gathers):
        d = plan["dims"][path]
        if d < 0:
            # replicated leaf: every rank runs the identical update
            opt._update_ctx(ctx, p, g, s, lr, step_no, seed=seed)
            return
        per = p.shape[d] if stage >= 3 else p.shape[d] // n
        seed = shard_window(seed, d, idx * per, per * n)
        if stage >= 3:
            opt._update_ctx(ctx, p, g, s, lr, step_no, seed=seed)
            return
        p_sh = _shard(p, d, idx, n)
        g_sh = g if stage >= 2 else _shard(g, d, idx, n)
        opt._update_ctx(ctx, p_sh, g_sh, s, lr, step_no, seed=seed)
        if n > 1:
            gathers.append((p, C.all_gather_into(p_sh, d, sgroup,
                                                 sync_op=False)))

    def _local_trees(params, grads):
        """(params, grads) in the state's layout: the shards at stages 1
        and 2 (copies), the resident shards at stage 3."""
        dims = plan["dims"]
        pairs = _tree.flatten(params)
        gl = dict(_tree.flatten(grads))
        ps, gs = [], []
        for path, p in pairs:
            d = dims[path] if stage < 3 else -1
            ps.append(_shard(p, d, idx, n))
            g = gl[path]
            gs.append(g if (g is None or stage >= 2) else _shard(g, d, idx, n))
        paths = [p for p, _ in pairs]
        return _tree.unflatten(paths, ps), _tree.unflatten(paths, gs)

    def _gather_back(params, local):
        if stage >= 3 or n == 1:
            return
        dims = plan["dims"]
        for (path, p), (_, ploc) in zip(_tree.flatten(params),
                                        _tree.flatten(local)):
            if dims[path] >= 0:
                p.copy_(C.all_gather_into(ploc, dims[path], sgroup))

    def _apply_own(params, grads, opt_state, lr):
        """An optimizer with an ``apply`` of its own runs it on this rank's
        slices (its clip then sees only them)."""
        enforce(clip is None or n == 1,
                f"{type(opt).__name__} applies its own clip inside its own "
                f"apply(); over {n} shards that clip would see local "
                f"gradients only", op="build_sharded_train_step")
        p_loc, g_loc = _local_trees(params, grads)
        p_loc, opt_state = opt.apply(p_loc, g_loc, opt_state, lr)
        _gather_back(params, p_loc)
        return params, opt_state

    @torch.no_grad()
    def _apply(params, grads, opt_state, lr):
        if not streamable:
            return _apply_own(params, grads, opt_state, lr)
        step_no = int(opt_state["step"]) + 1
        gathers = []
        for (path, _), (p, g, s, ctx, seed) in zip(
                _tree.flatten(params),
                opt._leaf_items(params, grads, opt_state["slots"], step_no)):
            if g is not None:
                _update_leaf(path, p, g, s, ctx, seed, lr, step_no, gathers)
        for p, w in gathers:
            p.copy_(w.wait())
        opt_state["step"] = step_no

    def step(params, opt_state, *batch_and_lr):
        *batch, lr = batch_and_lr
        if not donate:
            params, opt_state = _clone_tree(params, pinned), \
                _clone_tree(opt_state, pinned)
        batch = [_as_tensor(b, device) for b in batch]
        loss, grads = _grad_pass(params, batch)
        _apply(params, grads, opt_state, float(lr))
        return params, opt_state, loss

    # -- the offload step -----------------------------------------------------
    gbufs = {}      # path -> the pinned host buffer a gradient is parked in

    def _park_grads(grads):
        out = []
        pairs = _tree.flatten(grads)
        for path, g in pairs:
            if not _offloadable(g):
                out.append(g)
                continue
            if path not in gbufs:
                gbufs[path] = copier.park_new({"g": g})
            else:
                copier.park({"g": g}, gbufs[path])
            out.append(gbufs[path])
        return [p for p, _ in pairs], out

    @torch.no_grad()
    def _offload_apply(params, grads, opt_state, lr):
        step_no = int(opt_state["step"]) + 1
        paths, parked = _park_grads(grads)
        del grads
        if copier.cuda:
            # a gradient's fetch below must see its park complete
            copier.h2d.wait_stream(copier.d2h)
        items = [(path, it) for path, it in zip(
            paths, opt._leaf_items(params, _tree.unflatten(paths, parked),
                                   opt_state["slots"], step_no))
            if it[1] is not None]

        def fetch(k):
            path, (_, g, s, _, _) = items[k]
            return copier.fetch(g), copier.fetch(s)

        gathers = []
        nxt = fetch(0) if items else None
        for k, (path, (p, _, s_host, ctx, seed)) in enumerate(items):
            g_f, s_f = nxt
            nxt = fetch(k + 1) if k + 1 < len(items) else None
            g = g_f.get()
            g = g["g"] if isinstance(g, dict) else g
            s = s_f.get()
            _update_leaf(path, p, g, s, ctx, seed, lr, step_no, gathers)
            copier.park(s, s_host)
            del g, s
        for p, w in gathers:
            p.copy_(w.wait())
        copier.drain()
        opt_state["step"] = step_no

    def _offload_apply_own(params, grads, opt_state, lr):
        """A non-streamable optimizer: its own apply over the whole state,
        fetched to the device and parked back (the documented spike)."""
        pairs = _flatten_slots(opt_state["slots"],
                               [p for p, _ in _tree.flatten(params)])
        dev = [copier.fetch(seg).get() for _, seg in pairs]
        dev_state = dict(opt_state, slots=_tree.unflatten(
            [p for p, _ in pairs], dev))
        _, dev_state = _apply_own(params, grads, dev_state, lr)
        for path, seg in pairs:
            copier.park(_lookup(dev_state["slots"], path), seg)
        copier.drain()
        opt_state["step"] = dev_state["step"]

    def offload_step(params, opt_state, *batch_and_lr):
        *batch, lr = batch_and_lr
        copier.reset()
        if not donate:
            params, opt_state = _clone_tree(params, pinned), \
                _clone_tree(opt_state, pinned)
        batch = [_as_tensor(b, device) for b in batch]
        loss, grads = _grad_pass(params, batch)
        if streamable:
            _offload_apply(params, grads, opt_state, float(lr))
        else:
            _offload_apply_own(params, grads, opt_state, float(lr))
        return params, opt_state, loss

    def compile_for(params):
        del params
        batch_spec = (data_axes,)
        return (offload_step if offload else step), batch_spec

    step.copier = offload_step.copier = copier
    return step, place, compile_for


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flatten_slots(slots, paths):
    """(parameter path, slot dict) pairs of a slots tree keyed like the
    parameters."""
    return [(p, _lookup(slots, p)) for p in paths]


# ---------------------------------------------------------------------------
# eager API surface (the reference's group_sharded_parallel)
# ---------------------------------------------------------------------------
def group_sharded_parallel(model, optimizer, level: str, scaler=None,
                           group=None, mesh=None,
                           shard_axis: Optional[str] = None,
                           offload: bool = False, sync_buffers: bool = False,
                           **unused):
    """Wrap (model, optimizer, scaler) for ZeRO training (the reference's
    signature). The optimizer is wrapped by ``shard_optimizer`` so that
    ``init_state`` makes this rank's slot shards (parked in pinned host
    memory with ``offload=True``) and ``apply`` updates them; the model is
    returned as it is (sharding a layer's Parameters in place is ROADMAP
    Queue 1 item 10)."""
    enforce_in(level, LEVELS, op="group_sharded_parallel", name="level")
    del sync_buffers, unused
    from ..auto_parallel.api import (ShardingStage1, ShardingStage2,
                                     ShardingStage3, shard_optimizer)
    if mesh is None and group is not None:
        mesh = getattr(group, "mesh", None)
        if shard_axis is None:
            shard_axis = getattr(group, "axis_name", None)
    if mesh is None:
        from ..topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        enforce(hcg is not None,
                "group_sharded_parallel needs a mesh/group",
                op="group_sharded_parallel",
                error=PreconditionNotMetError)
        mesh = hcg.mesh
        if shard_axis is None:
            shard_axis = ("sharding" if mesh.shape.get("sharding", 1) > 1
                          else "dp")
    stage_cls = {1: ShardingStage1, 2: ShardingStage2, 3: ShardingStage3}[
        _STAGE_OF[level]]
    opt = shard_optimizer(optimizer, stage_cls(mesh, shard_axis), mesh,
                          offload=offload)
    return model, opt, scaler


def save_group_sharded_model(model, output, optimizer=None, opt_state=None):
    """Save the model's parameters and the optimizer state as full arrays
    (``output/model.pdparams`` and ``output/model.pdopt``, the port's
    ``framework.io.save``; global rank 0 writes them). ``opt_state`` made
    by a ``shard_optimizer`` wrapper (``optimizer``) is gathered from the
    ranks' shards first, which every rank of its axis must call."""
    from ...framework.io import save
    from ..auto_parallel.api import _ShardedOptimizer

    if opt_state is None and optimizer is not None:
        warnings.warn(
            "save_group_sharded_model: optimizer given but no state — "
            "pass opt_state= (the port's optimizers keep no eager state)")
    if opt_state is not None and isinstance(optimizer, _ShardedOptimizer):
        opt_state = optimizer._full_state(opt_state)
    rank = (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)
    if rank != 0:
        return
    os.makedirs(output, exist_ok=True)
    save(dict(model.state_dict()), os.path.join(output, "model.pdparams"))
    if opt_state is not None:
        save(opt_state, os.path.join(output, "model.pdopt"))
