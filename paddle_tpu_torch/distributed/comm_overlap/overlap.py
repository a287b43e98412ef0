"""Bucketed dp gradient sync whose collectives run under later compute
(counterpart: ``paddle_tpu/distributed/comm_overlap/overlap.py``:
``CommOverlapConfig``, ``config_from_flags``, ``reduce_bucketed``,
``reduce_scatter_tree``, ``microbatched_reduced_grads``, ``ef_plan_for``,
``ef_residual_specs``, ``init_ef_residuals``).

The JAX package issues these collectives inside one compiled program and
leaves their overlap to XLA's scheduler. Here each is a
``torch.distributed`` call issued ``async_op=True``: a reduction returns a
pending result whose ``wait()`` gives the reduced tree, and
``microbatched_reduced_grads`` waits on microbatch m's only after every
microbatch's backward has been issued, so on the card (NCCL runs on its own
stream) they run under microbatch m+1's backward. Each pending reduction
holds its own flat buffers until it is waited on.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from ...enforce import enforce, enforce_in
from ...flags import flag
from .. import collective as C
from .._tree import flatten, unflatten
from .bucketing import (BucketPlan, ShapeDtype, build_bucket_plan,
                        local_shape, pack_bucket, unpack_bucket)
from .quantize import ef_quantized_psum

__all__ = ["CommOverlapConfig", "config_from_flags", "reduce_bucketed",
           "reduce_scatter_tree", "microbatched_reduced_grads",
           "ef_plan_for", "init_ef_residuals", "ef_residual_specs",
           "value_and_grad", "Done", "Pending"]

_QUANT_MODES = ("", "int8")


@dataclasses.dataclass(frozen=True)
class CommOverlapConfig:
    """bucket_mb: target bucket size in MB of wire bytes (<= 0: one
    bucket). quantize: "" or "int8" (error-feedback all-reduce; the
    replicated path only). microbatches: gradient-accumulation slices,
    each slice's collectives issued before the next slice's compute.
    reduce_dtype: wire dtype of the full-precision path (None: each
    gradient's own)."""
    bucket_mb: float = 4.0
    quantize: str = ""
    microbatches: int = 1
    reduce_dtype: Any = None

    def __post_init__(self):
        enforce_in(self.quantize, _QUANT_MODES, op="CommOverlapConfig",
                   name="quantize")
        enforce(self.microbatches >= 1, "microbatches must be >= 1",
                op="CommOverlapConfig", microbatches=self.microbatches)

    @property
    def bucket_bytes(self) -> float:
        return self.bucket_mb * (1 << 20)


def config_from_flags() -> Optional[CommOverlapConfig]:
    """None (off) unless FLAGS_comm_bucket_mb / FLAGS_comm_quantize /
    FLAGS_comm_overlap_microbatches asks for the bucketed path."""
    bmb = float(flag("comm_bucket_mb"))
    quant = str(flag("comm_quantize") or "")
    micro = max(int(flag("comm_overlap_microbatches")), 1)
    if bmb <= 0 and not quant and micro <= 1:
        return None
    return CommOverlapConfig(bucket_mb=bmb if bmb > 0 else 0.0,
                             quantize=quant, microbatches=micro)


class Done:
    """A result that is already there (``wait()`` returns it)."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


class Pending:
    """Several pending collectives and the step that assembles their
    result once all are done."""

    def __init__(self, works, finish):
        self._works = works
        self._finish = finish
        self._result = None
        self._done = False

    def wait(self):
        if not self._done:
            vals = [w.wait() for w in self._works]
            self._result = self._finish(vals)
            self._done = True
        return self._result


def reduce_bucketed(grads, group, *, axis_size: int,
                    plan: Optional[BucketPlan] = None,
                    bucket_bytes: float = 0.0, quantize: str = "",
                    residuals: Optional[List[torch.Tensor]] = None,
                    reduce_dtype=None, weight: float = 1.0,
                    mean: bool = True, sync_op: bool = True):
    """Bucketed dp reduction of this rank's gradient tree: each bucket
    packed into one flat buffer and reduced by ONE collective (the int8
    error-feedback all-reduce with ``quantize="int8"``). ``weight``
    pre-scales the gradients (1/M for microbatch accumulation) before the
    quantization. Returns ``(reduced_tree, new_residuals)``
    (``new_residuals`` None unless quantized); ``sync_op=False`` returns
    ``(pending, new_residuals)``, ``pending.wait()`` giving the tree. None
    gradients are dropped, as ``jax.tree.flatten`` drops them."""
    pairs = [(p, g) for p, g in flatten(grads) if g is not None]
    paths = [p for p, _ in pairs]
    leaves = [g for _, g in pairs]
    if plan is None:
        plan = build_bucket_plan(leaves, bucket_bytes)
    new_residuals: Optional[List[torch.Tensor]] = [] if quantize else None
    works = []
    for bucket in plan.buckets:
        if quantize == "int8":
            flat = pack_bucket(leaves, bucket, dtype=torch.float32)
            if weight != 1.0:
                flat = flat * weight
            res = (residuals[bucket.index] if residuals is not None
                   else torch.zeros_like(flat))
            w, new_res = ef_quantized_psum(
                flat, res, group,
                mean_divisor=float(axis_size) if mean else 1.0,
                sync_op=False)
            new_residuals.append(new_res)
        else:
            flat = pack_bucket(leaves, bucket, dtype=reduce_dtype)
            if weight != 1.0:
                flat = flat * torch.tensor(weight, dtype=flat.dtype)
            w = C.all_reduce(flat, C.ReduceOp.SUM, group, sync_op=False)
            if mean:
                w = C.Work(w, lambda f=flat: f / axis_size)
        works.append(w)

    def finish(reduced):
        out = list(leaves)
        for bucket, red in zip(plan.buckets, reduced):
            for leaf_index, piece in unpack_bucket(red, bucket):
                out[leaf_index] = piece
        return unflatten(paths, out)
    pending = Pending(works, finish)
    return (pending.wait() if sync_op else pending), new_residuals


def reduce_scatter_tree(grads, zdims, group, *, axis_size: int,
                        reduce_dtype=None, weight: float = 1.0,
                        mean: bool = True, sync_op: bool = True):
    """The ZeRO gradient reduction: each leaf reduce-scattered over the
    group along its ``zdims`` dim (``zd < 0``: an all-reduce, the small
    replicated leaves); this rank keeps its contiguous shard. None
    gradients pass through. ``sync_op=False`` returns a pending result."""
    items = flatten(grads)
    zd_of = dict(flatten(zdims))
    works = []
    for path, g in items:
        if g is None:
            works.append(Done(None))
            continue
        gr = g.to(reduce_dtype) if reduce_dtype is not None else g
        if weight != 1.0:
            gr = gr * torch.tensor(weight, dtype=gr.dtype)
        zd = zd_of[path]
        if zd < 0:
            w = C.all_reduce(gr, C.ReduceOp.SUM, group, sync_op=False)
        else:
            w = C.reduce_scatter_into(gr, zd, group, sync_op=False)

        def fin(w=w, dt=g.dtype):
            r = w.wait()
            if mean:
                r = r / axis_size
            return r.to(dt)
        works.append(C.Work(None, fin))

    def finish(vals):
        return unflatten([p for p, _ in items], vals)
    pending = Pending(works, finish)
    return pending.wait() if sync_op else pending


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss detached, gradient tree) of ``loss_fn(params, *args)`` with
    respect to every leaf of ``params`` (``jax.value_and_grad``); a leaf
    the loss does not reach gets None."""
    pairs = flatten(params)
    leaves = [t for _, t in pairs]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return loss.detach(), unflatten([p for p, _ in pairs], list(grads))


def microbatched_reduced_grads(loss_fn: Callable, params,
                               batch_args: Sequence[torch.Tensor],
                               num_microbatches: int, reduce_fn: Callable,
                               residuals=None):
    """Gradient accumulation whose reductions overlap later microbatches.

    Splits each batch arg's leading dim into ``num_microbatches`` slices;
    for each, computes the slice's gradients and hands them to
    ``reduce_fn(grads, residuals) -> (pending, new_residuals)``, which
    issues the collectives (folding the 1/M weight) and returns at once.
    After the last slice every pending result is waited on, in order, and
    summed into an fp32 accumulator, then cast back to the reduced
    gradients' dtypes. Returns ``(mean_loss, grads, new_residuals)``."""
    M = int(num_microbatches)
    b = batch_args[0].shape[0]
    enforce(M >= 1 and b % M == 0,
            "comm-overlap microbatches must divide the local batch",
            op="comm_overlap.microbatched_reduced_grads", batch=b,
            microbatches=M)
    if M == 1:
        loss, g = value_and_grad(loss_fn, params, *batch_args)
        pending, res = reduce_fn(g, residuals)
        return loss, pending.wait(), res
    slices = [a.chunk(M, dim=0) for a in batch_args]
    pendings, lsum = [], None
    res = residuals
    for m in range(M):
        loss, g = value_and_grad(loss_fn, params, *(s[m] for s in slices))
        pending, res = reduce_fn(g, res)
        pendings.append(pending)
        del g
        lsum = loss if lsum is None else lsum + loss
    acc, dtypes = None, None
    for pending in pendings:
        red = flatten(pending.wait())
        if acc is None:
            dtypes = [None if r is None else r.dtype for _, r in red]
            acc = [None if r is None else r.float().clone() for _, r in red]
        else:
            for i, (_, r) in enumerate(red):
                if r is not None:
                    acc[i] += r.float()
    grads = unflatten([p for p, _ in red],
                      [None if a is None else a.to(dt)
                       for a, dt in zip(acc, dtypes)])
    return lsum / M, grads, res


# ---------------------------------------------------------------------------
# error-feedback residual state (threaded by the engine as
# opt_state["comm_ef"])
# ---------------------------------------------------------------------------
def ef_plan_for(example_params, specs, mesh,
                bucket_bytes: float) -> BucketPlan:
    """The bucket plan over each rank's gradient shapes, built once so the
    residual state and the reduction agree."""
    spec_of = dict(flatten(specs))
    local = [ShapeDtype(local_shape(p.shape, spec_of[path], mesh), p.dtype)
             for path, p in flatten(example_params)]
    return build_bucket_plan(local, bucket_bytes)


def ef_residual_specs(plan: BucketPlan, mesh) -> List[tuple]:
    """Each rank's residuals are its own rounding errors: one flat dim
    sharded over every mesh axis."""
    return [(tuple(mesh.axis_names),)] * plan.n_buckets


def init_ef_residuals(plan: BucketPlan, mesh, device=None) -> List[
        torch.Tensor]:
    """This rank's zero residuals, one flat fp32 buffer per bucket."""
    del mesh
    return [torch.zeros((b.size,), dtype=torch.float32, device=device)
            for b in plan.buckets]
