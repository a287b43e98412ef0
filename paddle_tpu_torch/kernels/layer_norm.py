"""Fused LayerNorm, forward and backward (counterpart:
``paddle_tpu/kernels/pallas/layer_norm.py`` ``layer_norm``, the
``jax.custom_vjp`` ``_ln`` / ``_ln_fwd`` / ``_ln_bwd``, kernel bodies
``_fwd_kernel`` and ``_bwd_kernel``).

The TPU kernels are replaced by CUDA kernels written by hand for Hopper,
``paddle_tpu_torch/csrc/layer_norm.cu``; its source note states the design:
one warp per row, 16-byte loads where the width allows, fp32 sums by warp
shuffles, any row count and any width. The forward computes the statistics
and the affine in fp32 and rounds once to x's dtype, as the Pallas kernel
does (the composed op rounds before its affine; at fp32 the two agree). It
saves ``mean`` and ``rstd`` as fp32 ``[rows]``. The backward kernel forms dx;
dw and db are fp32 cross-row sums outside the kernel, as the JAX backward
leaves them to one XLA reduce, and a bias-less call returns no db.

Wrappers: ``layer_norm_fwd`` (y, mean, rstd) and ``layer_norm_bwd_dx`` (dx),
each counting its kernel launches in ``.LAUNCHES``. A CUDA tensor goes to the
kernel or the call raises; a CPU tensor goes to the plain PyTorch version
(``layer_norm_fwd_plain``, ``layer_norm_bwd_plain``). ``layer_norm`` is the
differentiable public function over a ``torch.autograd.Function``.
"""

from __future__ import annotations

import torch

from ._build import check_rows, is_cpu, launch as _launch

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd_dx",
           "layer_norm_fwd_plain", "layer_norm_bwd_plain", "launch_fwd"]

# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to on the card)
# ---------------------------------------------------------------------------
def layer_norm_fwd_plain(x2, weight, bias, epsilon):
    """x2 [rows, H] -> (y in x2's dtype, mean fp32 [rows], rstd fp32
    [rows]): the kernel's arithmetic, fp32 throughout, one rounding."""
    xf = x2.float()
    mean = xf.mean(-1)
    xc = xf - mean[:, None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + epsilon)
    y = xc * rstd[:, None] * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mean, rstd


def _xhat(x2, mean, rstd):
    return (x2.float() - mean[:, None]) * rstd[:, None]


def layer_norm_bwd_plain(x2, weight, mean, rstd, dy, has_bias=True):
    """(dx in x2's dtype, dw fp32 [H], db fp32 [H] or None) from the saved
    statistics."""
    xhat = _xhat(x2, mean, rstd)
    dyf = dy.float()
    dxhat = dyf * weight.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    dw, db = _dw_db(xhat, dyf, has_bias)
    return dx.to(x2.dtype), dw, db


def _dw_db(xhat, dyf, has_bias):
    # the cross-row reductions the JAX backward leaves to XLA (fp32)
    return (dyf * xhat).sum(0), (dyf.sum(0) if has_bias else None)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _affine(t, H, what):
    """An [H] affine parameter as the kernels take it: fp32, contiguous."""
    if t.numel() != H:
        raise ValueError(f"layer_norm: {what} has {t.numel()} elements, the "
                         f"rows {H}")
    return t.reshape(H).float().contiguous()


def launch_fwd(x2, weight, bias, epsilon):
    """The forward kernel on a CUDA ``x2`` (uncounted: each caller counts its
    own launches; the tile primitives' LayerNorm runs it too)."""
    code = check_rows(x2, "layer_norm", weight,
                      *(() if bias is None else (bias,)))
    from ._build import load_library
    rows, H = x2.shape
    w = _affine(weight, H, "weight")
    b = None if bias is None else _affine(bias, H, "bias")
    y = torch.empty_like(x2)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2.device)
    _launch(f"layer_norm_fwd launch (rows={rows} H={H} {x2.dtype})",
            load_library().ptt_layer_norm_fwd, x2.device, x2.data_ptr(),
            w.data_ptr(), None if b is None else b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, H, float(epsilon), code)
    return y, mean, rstd


def layer_norm_fwd(x2, weight, bias, epsilon):
    """(y [rows, H] in x2's dtype, mean fp32 [rows], rstd fp32 [rows])."""
    if is_cpu(x2, "layer_norm"):
        return layer_norm_fwd_plain(x2, weight, bias, epsilon)
    out = launch_fwd(x2, weight, bias, epsilon)
    layer_norm_fwd.LAUNCHES += 1
    return out


def layer_norm_bwd_dx(x2, weight, mean, rstd, dy):
    """dx [rows, H] in x2's dtype from the forward's statistics."""
    if is_cpu(x2, "layer_norm"):
        return layer_norm_bwd_plain(x2, weight, mean, rstd, dy)[0]
    code = check_rows(x2, "layer_norm", weight, mean, rstd, dy)
    if dy.shape != x2.shape or dy.dtype != x2.dtype:
        raise ValueError(f"layer_norm backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} does not fit x {x2.dtype} "
                         f"{tuple(x2.shape)}")
    from ._build import load_library
    rows, H = x2.shape
    w = _affine(weight, H, "weight")
    mean, rstd, dy = mean.contiguous(), rstd.contiguous(), dy.contiguous()
    dx = torch.empty_like(x2)
    _launch(f"layer_norm_bwd launch (rows={rows} H={H} {x2.dtype})",
            load_library().ptt_layer_norm_bwd, x2.device, x2.data_ptr(),
            w.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), rows, H, code)
    layer_norm_bwd_dx.LAUNCHES += 1
    return dx


for _fn in (layer_norm_fwd, layer_norm_bwd_dx):
    _fn.LAUNCHES = 0


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------
class _LayerNorm(torch.autograd.Function):
    """The ``_ln`` custom_vjp: the forward saves (x, weight, mean, rstd);
    the backward runs the dx kernel and sums dw (and db) in fp32."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        H = x.shape[-1]
        x2 = x.reshape(-1, H).contiguous()
        y, mean, rstd = layer_norm_fwd(x2, weight, bias, epsilon)
        ctx.save_for_backward(x2, weight, mean, rstd)
        ctx.has_bias = bias is not None
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, mean, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = layer_norm_bwd_dx(x2, weight, mean, rstd, dy2)
            dx = dx.reshape(dy.shape)
        if ctx.needs_input_grad[1] or (ctx.has_bias
                                       and ctx.needs_input_grad[2]):
            dw, db = _dw_db(_xhat(x2, mean, rstd), dy2.float(), ctx.has_bias)
            dw = dw.to(weight.dtype).reshape(weight.shape)
            if db is not None:
                db = db.to(weight.dtype).reshape(weight.shape)
        return dx, dw, db, None


def layer_norm(x, weight, bias=None, epsilon=1e-5):
    """y = (x - mean) / sqrt(var + eps) * weight (+ bias) over the last
    axis, output in x's dtype (fp32 affine parameters never promote bf16
    rows). Differentiable in x, weight and bias; dw and db come back in
    the parameters' dtypes."""
    return _LayerNorm.apply(x, weight, bias, float(epsilon))
