"""The data-parallel train-step engine with ZeRO stages 0-3 (counterpart:
``paddle_tpu/models/hybrid_engine.py``: ``state_specs_for``, ``zero_dims``,
``zero_extend_spec``, ``zero_param_specs``, ``zero_state_specs``,
``zero1_state_specs``, ``_effective_clip``, the replication-aware global
norm and clip scale, and ``build_train_step``; the nonfinite count feeds
only the telemetry of ROADMAP Queue 1 item 9 and waits with it).

The JAX engine compiles one program per step under ``shard_map``. Here every
rank is a process that runs the same step on its slice of the batch and
meets the others in ``torch.distributed`` collectives over the mesh's dp
group: forward and backward, the dp gradient sync (a per-leaf all-reduce,
the bucketed / microbatched / int8 error-feedback schedule of
``distributed.comm_overlap``, or the ZeRO reduce-scatter), the optimizer
update, in place. Specs are the JAX ``PartitionSpec``s as tuples of axis
names (or None) per dim, and :func:`zero_dims` is the JAX rule itself, so a
tree sharded by either package has the same layout.

Per rank, what the step holds:

* stage 0: full parameters, full optimizer state; gradients all-reduced.
* stages 1 and 2: full parameters; each dp-shardable leaf's optimizer state
  is this rank's shard along its ``zero_dims`` dim (a contiguous tensor of
  its own); gradients reduce-scatter to that shard, the update runs on the
  shard and the new shards all-gather back into the full leaf. The two
  stages issue the same collectives (as in the JAX engine) and train bit
  for bit alike.
* stage 3: the dp-shardable parameters themselves are shards at rest; the
  loss gathers each on use (``comm_overlap.zero3``), the gather's backward
  reduce-scatters the gradient to the shard, and the update runs on the
  resident shard with no closing gather.

A leaf whose dp dim is not its first is a strided slice of the full leaf:
it is always copied into a contiguous tensor of its own before a kernel or
a collective sees it.

The MoE plan of a model builder (``moe``: ``{"ep_axis", "ef", "meta"}``)
runs at ep degree 1: the ep axis must be on the mesh, and the ep gradient
combine (``_ep_sync``) is the identity there.

Not ported, each raising NotImplementedError that names its ROADMAP Queue 1
item: mesh axes other than dp of degree > 1 (ep included), ``extra_grad_axes``
of degree > 1, ``mp_overlap``, ``flash`` and a MoE plan's error-feedback
residuals (item 6), ``fp8`` (item 7), telemetry and ``numerics`` (item 9).
``grad_reduce_dtype="auto"`` reads no fleet strategy here (the port has
none) and means None.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ..distributed import collective as C
from ..distributed import comm_overlap as _co
from ..distributed._tree import flatten, tree_map, unflatten
from ..distributed.comm_overlap.quantize import (replication_factor as
                                                 _replication_factor)
from ..distributed.parallel import shard_batch
from ..enforce import enforce
from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
from .convert import tensor_from_numpy

__all__ = ["build_train_step", "state_specs_for", "zero_dims",
           "zero_extend_spec", "zero_state_specs", "zero_param_specs",
           "zero1_state_specs", "shard_leaf"]


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 "
                               f"item {item})")


def _meta(leaf):
    """A meta tensor with ``leaf``'s shape and dtype."""
    return torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")


def state_specs_for(optimizer, specs, example_params=None):
    """Specs of the optimizer state ``{"step", "slots"}``: every slot tensor
    of a leaf takes the leaf's spec (when it has at least that many dims),
    the step replicates. Without ``example_params`` an fp32 example of
    ``(1,) * len(spec)`` stands in for each leaf (dtype-dependent slots,
    the multi_precision master, need the real example)."""
    if example_params is None:
        example_params = tree_map(
            lambda s: torch.empty((1,) * max(len(s), 1), device="meta"),
            specs)

    def slot_specs(spec, leaf):
        slot = optimizer._init_slot(_meta(leaf))
        return {k: (spec if len(spec) <= t.dim() else ())
                for k, t in slot.items()}
    return {"step": (), "slots": tree_map(slot_specs, specs,
                                          example_params)}


def zero_dims(specs, example_params, mesh, dp_axis: str):
    """Per-leaf dim to shard over the dp axis, the ONE rule for every ZeRO
    stage (the JAX engine's): the first dim with no mesh axis in the spec
    whose extent divides by the dp degree; -1 keeps the leaf replicated."""
    dp = mesh.shape[dp_axis]

    def dim_for(spec, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        for d in range(len(shape)):
            ax = spec[d] if d < len(spec) else None
            if ax is not None:
                continue
            local = int(shape[d])
            if local % dp == 0 and local >= dp:
                return d
        return -1
    return tree_map(dim_for, specs, example_params)


def zero_extend_spec(spec, zd, dp_axis: str, ndim: int):
    if zd < 0:
        return spec
    entries = list(spec) + [None] * (ndim - len(spec))
    entries[zd] = dp_axis
    return tuple(entries)


def zero_param_specs(specs, zdims, example_params, dp_axis: str = "dp"):
    """Stage-3 parameter specs: each dp-shardable leaf's spec grows the dp
    axis on its ``zero_dims`` dim."""
    return tree_map(lambda s, zd, p: zero_extend_spec(s, zd, dp_axis,
                                                      len(p.shape)),
                    specs, zdims, example_params)


def zero_state_specs(optimizer, specs, example_params, mesh,
                     dp_axis: str = "dp"):
    """(zdims, state specs) of the dp-sharded optimizer state."""
    zdims = zero_dims(specs, example_params, mesh, dp_axis)
    ext = zero_param_specs(specs, zdims, example_params, dp_axis)
    return zdims, state_specs_for(optimizer, ext, example_params)


def zero1_state_specs(optimizer, specs, example_params, mesh,
                      dp_axis: str = "dp"):
    return zero_state_specs(optimizer, specs, example_params, mesh, dp_axis)


def shard_leaf(x: torch.Tensor, zd: int, idx: int, n: int) -> torch.Tensor:
    """Rank ``idx``'s block of ``x`` along dim ``zd`` of ``n``, as a
    contiguous tensor of its own (``zd < 0``: ``x`` itself)."""
    if zd < 0:
        return x
    per = x.shape[zd] // n
    return x.narrow(zd, idx * per, per).contiguous()


def _effective_clip(opt):
    """(clip, owner) along a wrapper optimizer's ``_inner`` chain."""
    seen = set()
    o = opt
    while o is not None and id(o) not in seen:
        seen.add(id(o))
        c = getattr(o, "_grad_clip", None)
        if c is not None:
            return c, o
        o = getattr(o, "_inner", None)
    return None, None


def _repl_factor(spec, zd, mesh, dp_axis) -> int:
    """How many ranks hold a copy of the leaf (``zd >= 0`` adds the ZeRO
    dp sharding)."""
    extra = (dp_axis,) if (zd is not None and zd >= 0) else ()
    return _replication_factor(spec, mesh, extra_sharded=extra)


def _global_leaf_reduce(per_leaf, red, leaves_spec, leaves_z, mesh, dp_axis):
    """Each leaf's local ``per_leaf(g)`` (fp32) over its replication
    factor, summed over every rank: each distinct element once."""
    acc = None
    for g, sp, zd in zip(red, leaves_spec, leaves_z):
        if g is None:
            continue
        v = per_leaf(g) / _repl_factor(sp, zd, mesh, dp_axis)
        acc = v if acc is None else acc + v
    if acc is None:
        acc = torch.zeros((), dtype=torch.float32, device=mesh.device)
    return C.all_reduce(acc.reshape(1), C.ReduceOp.SUM)[0]


def _global_sq_norm(red, leaves_spec, leaves_z, mesh, dp_axis):
    return _global_leaf_reduce(lambda g: torch.sum(torch.square(g.float())),
                               red, leaves_spec, leaves_z, mesh, dp_axis)


def _global_clip_scale(red, leaves_spec, leaves_z, mesh, dp_axis, clip):
    """The true global-norm clip coefficient over sharded gradients."""
    n2 = _global_sq_norm(red, leaves_spec, leaves_z, mesh, dp_axis)
    return clip.scale_from_norm(torch.sqrt(n2))


def _fold_rank(seed, idx):
    """A dp-sharded leaf's rounding seed on rank ``idx``: each rank updates
    a distinct shard, so each gets its own stream (the JAX engine folds
    the rank into the leaf's key); rank 0 keeps the leaf's seed, so at dp 1
    the shard's noise is the full leaf's."""
    if seed is None or idx == 0:
        return seed
    return (seed[0], seed[1] + (idx << 20))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return tensor_from_numpy(x, device)


def build_train_step(loss_fn: Callable, specs: Dict[str, Any], mesh,
                     optimizer, data_spec=None, dp_axis: str = "dp",
                     extra_grad_axes=(), example_params=None,
                     grad_reduce_dtype="auto", zero1_dp: bool = False,
                     zero_stage=None, zero3=None, comm_overlap="auto",
                     fp8=None, telemetry="auto", mp_overlap=None, moe=None,
                     flash=None, numerics=None, donate: bool = False):
    """``loss_fn(params, tokens, labels) -> scalar`` runs on each rank on
    its slice of the batch (a 4th argument, the residual tree, and a
    ``(loss, new_residuals)`` return with a zero3 EF plan). Returns
    ``(step, shard_params, init_state)``:

    * ``shard_params(global_params)``: the global tree (tensors, or numpy
      arrays as the JAX package's ``jax.device_get`` gives them) -> this
      rank's tree on its device: full leaves, or at stage 3 the dp shards
      of the shardable leaves;
    * ``init_state(local_params)``: this rank's optimizer state (dp
      shards of the slots at stages 1-3), with ``{"opt", "comm_ef" /
      "zero3_ef"}`` around it when a residual carry rides along;
    * ``step(params, state, tokens, labels, lr) -> (params, state, loss)``
      over the GLOBAL batch (each rank takes its ``shard_batch`` slice of
      dim 0); ``loss`` is what ``loss_fn`` returns on this rank.

    The step updates ``params`` and ``state`` in place and returns them
    when ``donate=True``; with ``donate=False`` (the JAX default) it works
    on copies and leaves the caller's tensors as they were.

    ``zero_stage`` 0-3 (``zero1_dp=True`` is stage 1), ``zero3`` the stage-3
    plan a model builder threads (``{"ef": None or {"init"},
    "meta"}``), ``comm_overlap`` a ``CommOverlapConfig`` ("auto" reads the
    flags, None off), ``grad_reduce_dtype`` the wire dtype of the dp
    reduction; an optimizer with ``_skips_grad_sync`` gets unreduced
    gradients. See the JAX engine's docstring for each option's design."""
    if fp8 is not None:
        raise _not_ported("fp8 delayed scaling (fp8=)", 7)
    if telemetry not in ("auto", None):
        raise _not_ported("in-program telemetry (telemetry=)", 9)
    if numerics is not None:
        raise _not_ported("numerics telemetry (numerics=)", 9)
    if mp_overlap is not None:
        raise _not_ported("mp-axis overlap (mp_overlap=)", 6)
    if flash is not None:
        raise _not_ported("the FlashAttentionConfig plan (flash=)", 6)
    for a in mesh.axis_names:
        if a != dp_axis and mesh.shape[a] > 1:
            raise _not_ported(f"the mesh axis {a!r} of degree "
                              f"{mesh.shape[a]} (tensor / pipeline / "
                              f"sequence parallelism)", 6)
    for a in extra_grad_axes:
        if mesh.shape.get(a, 1) > 1:
            raise _not_ported(f"extra_grad_axes {a!r} of degree > 1", 6)
    # -- expert parallelism (the MoE plan of a model builder) ---------------
    if moe is not None:
        ep_axis = moe.get("ep_axis", "ep")
        enforce(ep_axis in mesh.axis_names,
                f"the MoE plan names ep axis '{ep_axis}' which the mesh "
                "does not define", op="build_train_step",
                axes=tuple(mesh.axis_names))
        if moe.get("ef") is not None:
            raise _not_ported("the MoE plan's error-feedback residuals "
                              "(moe_quantize_a2a)", 6)
    if grad_reduce_dtype == "auto":
        grad_reduce_dtype = None
    if data_spec is None:
        data_spec = (dp_axis,)
    dp = mesh.shape[dp_axis]
    idx = mesh.axis_index(dp_axis)
    group = mesh.group(dp_axis)
    device = mesh.device

    # -- ZeRO stage resolution (zero1_dp is the legacy stage-1 spelling) ----
    zero_stage = 0 if zero_stage is None else int(zero_stage)
    if zero1_dp:
        enforce(zero_stage in (0, 1),
                "zero1_dp is the legacy spelling of zero_stage=1 — do not "
                "combine it with a different explicit stage",
                op="build_train_step", zero_stage=zero_stage)
        zero_stage = 1
    zdims = None
    pspecs = specs
    if zero_stage:
        enforce(zero_stage in (1, 2, 3), "zero_stage must be one of 0/1/2/3",
                op="build_train_step", zero_stage=zero_stage)
        enforce(example_params is not None,
                "zero_stage needs example_params (leaf shapes pick the dp "
                "shard dims)", op="build_train_step")
        enforce(hasattr(optimizer, "_init_slot")
                and hasattr(optimizer, "_update_ctx"),
                "zero_stage re-runs the update per leaf shard; the "
                "optimizer must follow the per-leaf _init_slot/_update "
                f"protocol (AdamW-family). Got {type(optimizer).__name__}",
                op="build_train_step")
        enforce(not getattr(optimizer, "_skips_grad_sync", False),
                "LocalSGD/DGC own the dp axis — incompatible with "
                "zero_stage", op="build_train_step")
        zdims = zero_dims(specs, example_params, mesh, dp_axis)
        if zero_stage >= 3:
            pspecs = zero_param_specs(specs, zdims, example_params, dp_axis)
    z3_ef = (zero3 or {}).get("ef") if zero3 is not None else None
    if z3_ef is not None:
        enforce(zero_stage == 3,
                "a zero3 EF plan (quantized param all-gather) requires "
                "zero_stage=3", op="build_train_step", zero_stage=zero_stage)

    # -- bucketed/overlapped dp gradient collectives -------------------------
    skips_dp = getattr(optimizer, "_skips_grad_sync", False)
    ocfg = _co.config_from_flags() if comm_overlap == "auto" else comm_overlap
    if ocfg is not None and skips_dp:
        ocfg = None
    ef_plan = None
    if ocfg is not None and ocfg.quantize:
        enforce(not zero_stage,
                "comm_quantize=int8 is the replicated all-reduce path; "
                "the ZeRO stages reduce-scatter shards whose codes cannot "
                "share a bucket scale — disable one of the two",
                op="build_train_step")
        enforce(example_params is not None,
                "comm_quantize=int8 needs example_params (the "
                "error-feedback residual state is sized from the local "
                "gradient shapes at build time)", op="build_train_step")
        ef_plan = _co.ef_plan_for(example_params, specs, mesh,
                                  ocfg.bucket_bytes)
    if z3_ef is not None:
        enforce(ocfg is None,
                "zero3_quantize_ag threads ONE error-feedback residual "
                "slot per step; the comm_overlap path calls the loss once "
                "per comm microbatch and would sum residuals — disable "
                "FLAGS_comm_* or FLAGS_zero3_quantize_ag",
                op="build_train_step")

    # a residual carry rides the state as {"opt": ..., "comm_ef" /
    # "zero3_ef": ...}
    wrapped = ef_plan is not None or z3_ef is not None

    paths = [p for p, _ in flatten(specs)]
    spec_leaves = [s for _, s in flatten(specs)]
    z_leaves = ([z for _, z in flatten(zdims)] if zdims is not None
                else [-1] * len(paths))

    def shard_params(params):
        """The global tree -> this rank's tree on its device."""
        out = []
        for (path, v), zd in zip(flatten(params), z_leaves):
            t = _as_tensor(v, device)
            if zero_stage >= 3:
                t = shard_leaf(t, zd, idx, dp)
            out.append(t.contiguous())
        return unflatten(paths, out)

    def init_state(params):
        """This rank's optimizer state for its local parameters."""
        if zero_stage in (1, 2):
            slots = unflatten(paths, [
                optimizer._init_slot(shard_leaf(p, zd, idx, dp))
                for (_, p), zd in zip(flatten(params), z_leaves)])
            inner = {"step": 0, "slots": slots}
        else:
            inner = optimizer.init_state(params)
        extras = {}
        if ef_plan is not None:
            extras["comm_ef"] = _co.init_ef_residuals(ef_plan, mesh, device)
        if z3_ef is not None:
            extras["zero3_ef"] = tree_map(lambda t: t.to(device),
                                          z3_ef["init"]())
        if extras:
            return {"opt": inner, **extras}
        return inner

    init_state.param_specs = pspecs
    init_state.zdims = zdims
    init_state.zero_stage = zero_stage

    # -- the ZeRO update, every stage ---------------------------------------
    def _zero_apply(params, grads, opt_state, lr, pre_reduced=False):
        """Pass 1 reduces each gradient to this rank's shard (stage 3's
        sharded leaves arrive reduce-scattered by the gathers' backward:
        only the 1/dp of the loss mean is left); pass 2 updates the shard
        (stages 1/2 then gather the new shards back into the full leaf)."""
        step_no = int(opt_state["step"]) + 1
        items = optimizer._leaf_items(params, grads, opt_state["slots"],
                                      step_no)
        clip, _ = _effective_clip(optimizer)
        if pre_reduced:
            red = [g for (_, g, _, _, _) in items]
        else:
            pend = []
            for (p, g, s, ctx, seed), zd in zip(items, z_leaves):
                if g is None:
                    pend.append(None)
                elif zero_stage >= 3 and zd >= 0:
                    pend.append(_co.overlap.Done((g / dp).to(g.dtype)))
                else:
                    gr = (g.to(grad_reduce_dtype)
                          if grad_reduce_dtype is not None else g)
                    if zd < 0:
                        w = C.all_reduce(gr, C.ReduceOp.SUM, group,
                                         sync_op=False)
                    else:
                        w = C.reduce_scatter_into(gr, zd, group,
                                                  sync_op=False)
                    pend.append(C.Work(
                        None, lambda w=w, dt=g.dtype: (w.wait() / dp).to(dt)))
            red = [None if w is None else w.wait() for w in pend]

        scale = None
        if isinstance(clip, ClipGradByGlobalNorm):
            scale = _global_clip_scale(red, spec_leaves, z_leaves, mesh,
                                       dp_axis, clip)
        elif clip is not None and not isinstance(clip, ClipGradByValue):
            raise NotImplementedError(
                f"zero_stage supports global-norm/by-value clip, got "
                f"{type(clip).__name__}")

        gathers = []
        for (p, _, s, ctx, seed), g, zd in zip(items, red, z_leaves):
            if g is None:
                continue
            if isinstance(clip, ClipGradByValue):
                g = torch.clamp(g, clip.min, clip.max).to(g.dtype)
            if scale is not None:
                g = (g * scale).to(g.dtype)
            if zd < 0:
                # replicated leaf: every rank runs the identical update
                optimizer._update_ctx(ctx, p, g, s, lr, step_no, seed=seed)
            elif zero_stage >= 3:
                optimizer._update_ctx(ctx, p, g, s, lr, step_no,
                                      seed=_fold_rank(seed, idx))
            else:
                p_sh = shard_leaf(p, zd, idx, dp)
                optimizer._update_ctx(ctx, p_sh, g, s, lr, step_no,
                                      seed=_fold_rank(seed, idx))
                gathers.append((p, C.all_gather_into(p_sh, zd, group,
                                                     sync_op=False)))
        for p, w in gathers:
            p.copy_(w.wait())
        opt_state["step"] = step_no
        return params, opt_state

    # -- the bucketed / microbatched path -----------------------------------
    def _overlap_grads(params, tokens, labels, residuals):
        weight = 1.0 / ocfg.microbatches
        wire = (ocfg.reduce_dtype if ocfg.reduce_dtype is not None
                else grad_reduce_dtype)

        def reduce_fn(g, res):
            if zero_stage >= 3:
                # sharded leaves arrived summed at the shard (the gathers'
                # backward); only the replicated ones need a collective
                def z3_one(path, g_):
                    if g_ is None:
                        return _co.overlap.Done(None)
                    if zd_of[path] >= 0:
                        return _co.overlap.Done(
                            (g_ * torch.tensor(weight / dp, dtype=g_.dtype))
                            .to(g_.dtype))
                    gr = g_.to(wire) if wire is not None else g_
                    gr = gr * torch.tensor(weight, dtype=gr.dtype)
                    w = C.all_reduce(gr, C.ReduceOp.SUM, group,
                                     sync_op=False)
                    return C.Work(None, lambda w=w, dt=g_.dtype:
                                   (w.wait() / dp).to(dt))
                items = flatten(g)
                works = [z3_one(p, g_) for p, g_ in items]
                return _co.overlap.Pending(
                    works, lambda vals: unflatten([p for p, _ in items],
                                                  vals)), res
            if zero_stage:
                return _co.reduce_scatter_tree(
                    g, zdims, group, axis_size=dp, reduce_dtype=wire,
                    weight=weight, sync_op=False), res
            return _co.reduce_bucketed(
                g, group, axis_size=dp, plan=ef_plan,
                bucket_bytes=ocfg.bucket_bytes, quantize=ocfg.quantize,
                residuals=res,
                reduce_dtype=(None if ocfg.quantize else wire),
                weight=weight, sync_op=False)

        return _co.microbatched_reduced_grads(
            loss_fn, params, (tokens, labels), ocfg.microbatches, reduce_fn,
            residuals=residuals)

    zd_of = dict(flatten(zdims)) if zdims is not None else {}

    def _plain_reduce(grads):
        """The monolithic dp reduction: one all-reduce per leaf, all
        issued before the first is waited on."""
        if skips_dp:
            return grads
        pend = []
        for path, g in flatten(grads):
            if g is None:
                pend.append((path, None))
                continue
            gr = (g.to(grad_reduce_dtype) if grad_reduce_dtype is not None
                  else g)
            w = C.all_reduce(gr, C.ReduceOp.SUM, group, sync_op=False)
            pend.append((path, C.Work(None, lambda w=w, dt=g.dtype:
                                       (w.wait() / dp).to(dt))))
        return unflatten([p for p, _ in pend],
                         [None if w is None else w.wait() for _, w in pend])

    def _ep_sync(grads):
        """The ep gradient combine of a MoE plan: the identity at ep degree
        1, the only degree built (every expert leaf holds all of its
        tokens' contributions, every other leaf is this rank's alone)."""
        return grads

    def _apply(params, grads, opt_state, lr):
        # on a dp-only mesh the reduced gradients ARE the full tensors, so
        # the optimizer's own clip (inside apply) is already global
        return optimizer.apply(params, grads, opt_state, lr)

    def step(params, opt_state, tokens, labels, lr):
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        lr = float(lr)
        tokens, labels = (_as_tensor(t, device) for t in (tokens, labels))
        if data_spec and (data_spec[0] == dp_axis
                          or isinstance(data_spec[0], tuple)):
            # the batch dim over dp, or over (dp, ep) row-major (MoE)
            tokens, labels = (shard_batch(t, mesh, data_spec[0])
                              for t in (tokens, labels))
        ef = zef = None
        inner = opt_state
        if wrapped:
            ef = opt_state.get("comm_ef")
            zef = opt_state.get("zero3_ef")
            inner = opt_state["opt"]
        if ocfg is not None:
            loss, grads, ef = _overlap_grads(params, tokens, labels, ef)
            with torch.no_grad():
                if zero_stage:
                    _zero_apply(params, grads, inner, lr, pre_reduced=True)
                else:
                    _apply(params, grads, inner, lr)
        else:
            if z3_ef is not None:
                box = {}

                def loss_aux(p, t, l):
                    out, box["res"] = loss_fn(p, t, l, zef)
                    return out
                loss, grads = _co.overlap.value_and_grad(loss_aux, params,
                                                         tokens, labels)
                zef = box["res"]
            else:
                loss, grads = _co.overlap.value_and_grad(loss_fn, params,
                                                         tokens, labels)
            if moe is not None:
                grads = _ep_sync(grads)
            with torch.no_grad():
                if zero_stage:
                    _zero_apply(params, grads, inner, lr)
                else:
                    _apply(params, _plain_reduce(grads), inner, lr)
        if wrapped:
            if ef_plan is not None:
                opt_state["comm_ef"] = ef
            if z3_ef is not None:
                opt_state["zero3_ef"] = zef
        return params, opt_state, loss

    return step, shard_params, init_state

