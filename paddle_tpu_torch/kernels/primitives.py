"""Portable tile primitives (counterpart: ``paddle_tpu/kernels/pallas/
primitives.py``, the KPS twin of PaddlePaddle's Kernel Primitive API,
``paddle/phi/kernels/primitive/``, SURVEY §2.2): building blocks for custom
kernel authors, who write only the per-element math.

Primitives:
  elementwise(fn, *arrays)            y = fn(*xs) over arrays of one shape
  row_reduce(fn, identity, x)         [*, C] -> [*] in fp32 with fn
  online_softmax_update(s, m, l, acc) the flash kernels' streaming-softmax
                                      update, shared math (no kernel)
  layer_norm(x, g, b)                 row LayerNorm, forward and backward
                                      with dg / db summed in the kernel

On a CUDA tensor each primitive launches a CUDA kernel written for Hopper,
or the call raises:

- ``elementwise`` and ``row_reduce`` compile the caller's ``fn`` into the
  kernel body, as Pallas does. ``kernels/_codegen.py`` traces ``fn`` into a
  small IR over a closed op set and emits it into the templates
  ``csrc/kps_elementwise.cuh`` / ``csrc/kps_row_reduce.cuh``; one library is
  built per distinct (IR, operand dtypes, output dtype) at first use. An op
  outside the set, a captured tensor, or an operand outside float32 /
  bfloat16 / float16 raises ``NotImplementedError`` naming it.
- ``layer_norm`` runs ``csrc/layer_norm.cu``'s forward (the same arithmetic
  as ``_ln_fwd_kernel``) and its backward with dw and db (the same
  arithmetic as ``_ln_bwd_kernel``, dg and db summed inside the one launch,
  deterministically, at any width), the kernels of ``kernels/layer_norm.py``.

On a CPU tensor each takes its plain PyTorch version (``*_plain`` below):
the same arithmetic, fp32 throughout with one rounding. Each kernel wrapper
counts its launches in ``.LAUNCHES``: ``elementwise``, ``row_reduce``,
``ln_fwd``, ``ln_bwd``.

``block_rows`` and ``block_cols`` keep the JAX signatures: they are TPU tile
hints, which the port ignores. So is the JAX ``row_reduce``'s rule that C be
a multiple of the 128-lane width: any C works here.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from ..enforce import InvalidArgumentError
from ._build import is_cpu, launch as _launch

__all__ = ["elementwise", "row_reduce", "online_softmax_update",
           "layer_norm"]

def _as2d(x):
    """[*, C] view -> ([R, C], the original shape); a 0-d x -> [1, 1]."""
    x = torch.as_tensor(x)
    if x.dim() == 0:
        return x.reshape(1, 1), ()
    return x.reshape(math.prod(x.shape[:-1]), x.shape[-1]), tuple(x.shape)


def _same_device(xs, what):
    for t in xs[1:]:
        if t.device != xs[0].device:
            raise ValueError(f"{what}: an operand is on {t.device}, the "
                             f"first on {xs[0].device}")


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
def elementwise_plain(fn: Callable, xs2, out_dtype):
    """fn on fp32 upcasts of the [R, C] operands, rounded once to
    ``out_dtype``."""
    y = torch.as_tensor(fn(*(x.float() for x in xs2)))
    return y.to(out_dtype).expand(xs2[0].shape)


def _elementwise_kernel(fn, xs2, out_dtype):
    from . import _codegen
    _same_device(xs2, "elementwise")
    graph = _codegen.trace(fn, len(xs2))
    src = _codegen.elementwise_source(graph, [x.dtype for x in xs2],
                                      out_dtype)
    lib = _codegen.library(src)
    xs2 = [x.contiguous() for x in xs2]
    out = torch.empty(xs2[0].shape, dtype=out_dtype, device=xs2[0].device)
    ptrs = (ctypes.c_void_p * len(xs2))(*(x.data_ptr() for x in xs2))
    _launch(f"elementwise launch ({tuple(out.shape)} "
            f"{[str(x.dtype) for x in xs2]} -> {out_dtype})",
            lib.ptt_kps_elementwise, out.device, ptrs, len(xs2),
            out.data_ptr(), out.numel(),
            error_string=lib.ptt_kps_error_string)
    elementwise.LAUNCHES += 1
    return out


def elementwise(fn: Callable, *arrays, block_rows: int = 256,
                out_dtype=None):
    """KPS ElementwiseUnary / Binary / Ternary: ``fn(*arrays)`` element by
    element, in fp32, rounded once to ``out_dtype`` (default: the first
    array's dtype). The arrays share one shape (broadcast upstream), else
    InvalidArgumentError; a 0-d input gives a 0-d result. ``block_rows`` is
    a TPU tile hint, ignored."""
    del block_rows
    xs2, shapes = zip(*(_as2d(a) for a in arrays))
    r, c = xs2[0].shape
    for a in xs2[1:]:
        if tuple(a.shape) != (r, c):
            raise InvalidArgumentError(
                f"elementwise primitive needs equal shapes, got "
                f"{[tuple(a.shape) for a in xs2]}")
    out_dtype = out_dtype or xs2[0].dtype
    if is_cpu(xs2[0], "elementwise"):
        _same_device(xs2, "elementwise")
        out = elementwise_plain(fn, xs2, out_dtype)
    else:
        out = _elementwise_kernel(fn, xs2, out_dtype)
    return out.reshape(shapes[0]) if shapes[0] != () else out[0, 0]


elementwise.LAUNCHES = 0


# ---------------------------------------------------------------------------
# row_reduce
# ---------------------------------------------------------------------------
def row_reduce_plain(fn: Callable, identity, x2):
    """[R, C] -> fp32 [R]: fn over fp32 columns, folded pairwise (log2 C
    calls of fn on [R, C/2^k] slices; fn is associative), then
    ``fn(identity, fold)``."""
    t = x2.float()
    acc = torch.full((t.shape[0],), float(identity), dtype=torch.float32,
                     device=t.device)
    if t.shape[1] == 0:
        return acc
    while t.shape[1] > 1:
        half = t.shape[1] // 2
        folded = fn(t[:, :half], t[:, half:2 * half])
        t = torch.cat([folded, t[:, 2 * half:]], dim=1) \
            if t.shape[1] % 2 else folded
    return fn(acc, t[:, 0]).float()


def _row_reduce_kernel(fn, identity, x2):
    from . import _codegen
    graph = _codegen.trace(fn, 2)
    src = _codegen.row_reduce_source(graph, float(identity), x2.dtype)
    lib = _codegen.library(src)
    x2 = x2.contiguous()
    rows, C = x2.shape
    out = torch.empty(rows, dtype=torch.float32, device=x2.device)
    _launch(f"row_reduce launch ({tuple(x2.shape)} {x2.dtype})",
            lib.ptt_kps_row_reduce, x2.device, x2.data_ptr(), out.data_ptr(),
            rows, C, error_string=lib.ptt_kps_error_string)
    row_reduce.LAUNCHES += 1
    return out


def row_reduce(fn: Callable, identity, x, block_rows: int = 256,
               block_cols: int = 2048):
    """KPS Reduce (row mode): [*, C] -> fp32 [*], starting from
    ``identity``, for an associative and commutative elementwise ``fn``
    (``torch.add``, ``torch.maximum``, ``torch.minimum``, ...). Any C; the
    block sizes are TPU tile hints, ignored."""
    del block_rows, block_cols
    x2, shape = _as2d(x)
    if is_cpu(x2, "row_reduce"):
        out = row_reduce_plain(fn, identity, x2)
    else:
        out = _row_reduce_kernel(fn, identity, x2)
    return out.reshape(shape[:-1])


row_reduce.LAUNCHES = 0


# ---------------------------------------------------------------------------
# online softmax (shared math)
# ---------------------------------------------------------------------------
def online_softmax_update(s, m_prev, l_prev, acc_prev, v=None):
    """The streaming-softmax update rule of every flash kernel: returns
    (m, l, acc, p). s: [bq, bk] scores tile; acc accumulates p @ v (p cast
    to v's dtype, the products summed in fp32) when v is given, else p
    itself."""
    m = torch.maximum(m_prev, s.amax(-1))
    alpha = torch.exp(m_prev - m)
    p = torch.exp(s - m[:, None])
    l = l_prev * alpha + p.sum(-1)
    if v is not None:
        pv = torch.matmul(p.to(v.dtype).float(), v.float())
        acc = acc_prev * alpha[:, None] + pv
    else:
        acc = acc_prev * alpha[:, None] + p
    return m, l, acc, p


# ---------------------------------------------------------------------------
# layer_norm
# ---------------------------------------------------------------------------
def ln_fwd_plain(x2, weight, bias, eps):
    """x2 [R, H] -> (y in x2's dtype, mean fp32 [R], rstd fp32 [R]): the
    statistics and the affine in fp32, one rounding."""
    xf = x2.float()
    mu = xf.mean(-1)
    xc = xf - mu[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    y = xc * rstd[:, None] * weight.float() + bias.float()
    return y.to(x2.dtype), mu, rstd


def ln_bwd_plain(x2, weight, mean, rstd, dy):
    """(dx in x2's dtype, dg fp32 [H], db fp32 [H])."""
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    dyf = dy.float()
    dyg = dyf * weight.float()
    c1 = dyg.mean(-1, keepdim=True)
    c2 = (dyg * xhat).mean(-1, keepdim=True)
    dx = (dyg - c1 - xhat * c2) * rstd[:, None]
    return dx.to(x2.dtype), (dyf * xhat).sum(0), dyf.sum(0)


def ln_fwd(x2, weight, bias, eps):
    """(y, mean, rstd): ``csrc/layer_norm.cu``'s forward on a CUDA tensor."""
    if is_cpu(x2, "layer_norm"):
        return ln_fwd_plain(x2, weight, bias, eps)
    from .layer_norm import launch_fwd
    out = launch_fwd(x2.contiguous(), weight, bias, eps)
    ln_fwd.LAUNCHES += 1
    return out


def ln_bwd(x2, weight, mean, rstd, dy):
    """(dx, dg fp32 [H], db fp32 [H]): ``csrc/layer_norm.cu``'s backward on a
    CUDA tensor (``layer_norm.launch_bwd`` with dw and db), one launch, dg
    and db bit for bit the same across calls, any width."""
    if is_cpu(x2, "layer_norm"):
        return ln_bwd_plain(x2, weight, mean, rstd, dy)
    from .layer_norm import launch_bwd
    dx, dg, db, _ = launch_bwd(x2.contiguous(), weight, mean, rstd,
                               dy.contiguous())
    ln_bwd.LAUNCHES += 1
    return dx, dg, db


for _fn in (ln_fwd, ln_bwd):
    _fn.LAUNCHES = 0


class _LayerNorm(torch.autograd.Function):
    """The JAX ``layer_norm`` custom_vjp: the forward saves (x, weight, mean,
    rstd); the backward returns dx in x's dtype and dg / db cast to the
    weight's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        x2, shape = _as2d(x)
        y, mean, rstd = ln_fwd(x2, weight, bias, eps)
        ctx.save_for_backward(x2, weight, mean, rstd)
        ctx.shape = shape
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, mean, rstd = ctx.saved_tensors
        dx, dg, db = ln_bwd(x2, weight, mean, rstd, dy.reshape(x2.shape))
        dg, db = (t.to(weight.dtype).reshape(weight.shape) for t in (dg, db))
        return dx.reshape(ctx.shape), dg, db, None


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """Row LayerNorm over the last dim with weight and bias (both required):
    fp32 statistics and affine, one rounding to x's dtype. Differentiable in
    x, weight and bias; dg and db are summed in fp32 inside the backward
    kernel and come back in the weight's dtype."""
    if weight is None or bias is None:
        raise InvalidArgumentError("layer_norm primitive takes a weight and "
                                   "a bias")
    return _LayerNorm.apply(x, weight, bias, float(eps))
