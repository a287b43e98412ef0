"""int8 all-reduce with error feedback (counterpart:
``paddle_tpu/distributed/comm_overlap/quantize.py``: ``quantize_int8``,
``dequantize_int8``, ``ef_quantized_psum``, ``spec_axes``,
``replication_factor``, ``residual_sq_norm``).

Per bucket: every rank agrees on one scale first (a MAX all-reduce of the
local absmax), quantizes its residual-corrected values onto that grid
(round half to even, as ``jnp.round``), keeps its rounding error as the
residual for the next reduction, and the group sums the codes as int32,
exactly. Only the wire is int8; the values and residuals stay fp32.
"""

from __future__ import annotations

import torch

from .. import collective as C
from .._tree import flatten

__all__ = ["quantize_int8", "dequantize_int8", "ef_quantized_psum",
           "spec_axes", "replication_factor", "residual_sq_norm"]

_QMAX = 127.0
_TINY = torch.finfo(torch.float32).tiny


def spec_axes(spec) -> set:
    """The mesh axes a spec shards over (nested tuples flattened)."""
    s = set()
    for e in spec:
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            s.add(a)
    return s


def replication_factor(spec, mesh, extra_sharded=()) -> int:
    """How many ranks hold a copy of a leaf with this spec: the product of
    the mesh axes it is not sharded over (``extra_sharded``: axes sharded
    outside the spec, the engine's ZeRO dp dim)."""
    sharded = spec_axes(spec) | set(extra_sharded)
    repl = 1
    for a in mesh.axis_names:
        if a not in sharded:
            repl *= mesh.shape[a]
    return repl


def residual_sq_norm(tree, specs, mesh) -> torch.Tensor:
    """Replication-aware global sum of squares of an error-feedback carry:
    each leaf's local sum of squares over its replication factor, summed
    over every rank (one all-reduce)."""
    acc = None
    spec_of = dict(flatten(specs)) if isinstance(specs, dict) else None
    for i, (path, t) in enumerate(flatten(tree) if isinstance(tree, dict)
                                  else [((j,), x)
                                        for j, x in enumerate(tree)]):
        if t is None:
            continue
        sp = spec_of[path] if spec_of is not None else specs[i]
        repl = (replication_factor(sp, mesh) if isinstance(sp, tuple)
                else mesh.size)
        v = torch.sum(torch.square(t.float())) / repl
        acc = v if acc is None else acc + v
    if acc is None:
        acc = torch.zeros((), dtype=torch.float32)
    return C.all_reduce(acc, C.ReduceOp.SUM)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric round-to-nearest-even onto ``scale * [-127, 127]``."""
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def ef_quantized_psum(flat: torch.Tensor, residual: torch.Tensor, group,
                      mean_divisor: float = 1.0, sync_op: bool = True):
    """Error-feedback int8 all-reduce of one flat bucket over ``group``.

    Returns ``(reduced, new_residual)``: the fp32 group sum of the
    residual-corrected inputs over ``mean_divisor``, and this rank's
    rounding error. ``sync_op=False`` returns ``(work, new_residual)``,
    ``work.wait()`` giving ``reduced`` (the scale's MAX all-reduce is
    waited on inside: the codes need it)."""
    x = flat.float() + residual
    absmax = torch.amax(torch.abs(x)).reshape(1)
    # every rank must quantize onto the same grid or the summed codes
    # would mean nothing
    shared = C.all_reduce(absmax, C.ReduceOp.MAX, group)[0]
    scale = torch.clamp(shared, min=_TINY) / _QMAX
    q = quantize_int8(x, scale)
    new_residual = x - dequantize_int8(q, scale)
    codes = q.to(torch.int32)
    work = C.all_reduce(codes, C.ReduceOp.SUM, group, sync_op=False)
    w = C.Work(work, lambda: codes.float() * scale / mean_divisor)
    return (w.wait() if sync_op else w), new_residual
