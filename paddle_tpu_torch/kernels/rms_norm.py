"""Fused RMSNorm, forward and backward (counterpart:
``paddle_tpu/kernels/pallas/rms_norm.py`` ``rms_norm``, the
``jax.custom_vjp`` over ``_rms_fwd`` / ``_rms_bwd``, kernel bodies
``_fwd_kernel`` and ``_bwd_kernel``).

The TPU kernels are replaced by CUDA kernels written by hand for Hopper,
``paddle_tpu_torch/csrc/rms_norm.cu``; its source note states the design:
one warp per row, the row held in registers where it fits (bf16 H <= 2048),
fp32 sums by warp shuffles, any row count and any width. The forward
computes ``x * rsqrt(mean(x^2) + eps) * w`` in fp32 and rounds once to x's
dtype, as the Pallas kernel does; it saves ``rstd`` as fp32 ``[rows]``.
Where the row is held, the forward is a persistent grid whose warps walk
rows with their weights in registers and two row buffers. The
backward forms dx and, in the same launch, dw: the fp32 cross-row sum
``sum(dy * x * rstd)`` that the JAX backward leaves to one XLA reduce (a
cooperative launch of one block an SM; each block's partial in registers
or a column-tiled workspace row, folded over the grid in a fixed order, so
two calls give the same bits). The wrapper casts dw to the weight's dtype.
A frozen weight takes the dx-only kernels, a frozen x skips the dx stores.

Wrappers: ``rms_norm_fwd`` (y, rstd) and ``rms_norm_bwd`` (dx, dw), each
counting its kernel launches in ``.LAUNCHES``; ``fwd_plan`` and
``bwd_plan`` report the forward's and the backward's path and grid. A CUDA
tensor goes to the kernel or the call raises; a CPU tensor goes to the
plain PyTorch version
(``rms_norm_fwd_plain``, ``rms_norm_bwd_plain``). ``rms_norm`` is the
differentiable public function over a ``torch.autograd.Function``.
"""

from __future__ import annotations

import functools

import torch

from ._build import check_rows, is_cpu, launch as _launch

__all__ = ["rms_norm", "supported", "rms_norm_fwd", "rms_norm_bwd",
           "rms_norm_fwd_plain", "rms_norm_bwd_plain", "fwd_plan",
           "bwd_plan"]

def supported(x, weight) -> bool:
    """The Pallas module's gate: rows of at least 2-D x whose last dim is
    the weight's length."""
    return x.dim() >= 2 and weight.numel() == x.shape[-1]


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to on the card)
# ---------------------------------------------------------------------------
def rms_norm_fwd_plain(x2, weight, epsilon):
    """x2 [rows, H] -> (y in x2's dtype, rstd fp32 [rows]): the kernel's
    arithmetic, fp32 throughout, one rounding."""
    xf = x2.float()
    rstd = torch.rsqrt((xf * xf).mean(-1) + epsilon)
    y = xf * rstd[:, None] * weight.float().reshape(-1)
    return y.to(x2.dtype), rstd


def rms_norm_bwd_plain(x2, weight, rstd, dy, need_dx=True, need_dw=True):
    """(dx in x2's dtype, dw fp32 [H]) from the saved rstd; None for what
    is not needed. dw is the cross-row reduction the JAX backward leaves to
    XLA (fp32)."""
    xf, dyf = x2.float(), dy.float()
    dx = dw = None
    if need_dx:
        dyw = dyf * weight.float().reshape(-1)
        dot = (dyw * xf).sum(-1, keepdim=True)
        r = rstd[:, None]
        dx = (r * dyw - r ** 3 * xf * dot / x2.shape[-1]).to(x2.dtype)
    if need_dw:
        dw = (dyf * xf * rstd[:, None]).sum(0)
    return dx, dw


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check(x2, weight, *more):
    """(dtype code, the weight as the kernels take it: fp32 [H])."""
    code = check_rows(x2, "rms_norm", weight, *more)
    if weight.numel() != x2.shape[1]:
        raise ValueError(f"rms_norm: the weight has {weight.numel()} "
                         f"elements, the rows {x2.shape[1]}")
    return code, weight.reshape(-1).float().contiguous()


def rms_norm_fwd(x2, weight, epsilon):
    """(y [rows, H] in x2's dtype, rstd fp32 [rows])."""
    if is_cpu(x2, "rms_norm"):
        return rms_norm_fwd_plain(x2, weight, epsilon)
    code, w = _check(x2, weight)
    from ._build import load_library
    rows, H = x2.shape
    y = torch.empty_like(x2)
    rstd = torch.empty(rows, dtype=torch.float32, device=x2.device)
    _launch(f"rms_norm_fwd launch (rows={rows} H={H} {x2.dtype})",
            load_library().ptt_rms_norm_fwd, x2.device, x2.data_ptr(),
            w.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows, H,
            float(epsilon), code)
    rms_norm_fwd.LAUNCHES += 1
    return y, rstd


@functools.lru_cache(maxsize=256)
def _plan(device_index, rows, H, code, aligned, forward=False):
    import ctypes
    from ._build import check, load_library
    out = (ctypes.c_int * 2)()
    lib = load_library()
    entry = lib.ptt_rms_norm_fwd_plan if forward else lib.ptt_rms_norm_bwd_plan
    with torch.cuda.device(device_index):
        check(entry(rows, H, code, int(aligned), out),
              f"rms_norm {'forward' if forward else 'backward'} plan "
              f"(rows={rows} H={H})")
    other = "walk" if forward else "tiled"
    return dict(path="held" if out[0] else other, blocks=out[1])


def fwd_plan(x2, weight, y=None) -> dict:
    """The forward's route for these CUDA tensors (no data is read): ``path``
    "held" (a persistent grid, the row and the weights in registers) or
    "walk" (one warp a row, the row read again), and ``blocks``, the grid."""
    code, w = _check(x2, weight)
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x2, w, y) if t is not None)
    return _plan(x2.device.index, x2.shape[0], x2.shape[1], code, aligned,
                 True)


def bwd_plan(x2, weight, dy=None) -> dict:
    """The dw backward's route for these CUDA tensors (no data is read):
    ``path`` "held" (the row in registers, dw partials in registers) or
    "tiled" (any width: a column-tiled partial), and ``blocks``, the grid of
    the cooperative launch and the rows of its [blocks, H] workspace."""
    code, w = _check(x2, weight)
    ptrs = [x2, w] + ([] if dy is None else [dy])
    aligned = all(t.data_ptr() % 16 == 0 for t in ptrs)
    return _plan(x2.device.index, x2.shape[0], x2.shape[1], code, aligned)


def rms_norm_bwd(x2, weight, rstd, dy, need_dx=True, need_dw=True):
    """(dx [rows, H] in x2's dtype, dw fp32 [H]) from the forward's rstd, in
    one launch; None for what is not needed (``need_dw=False`` takes the
    dx-only kernels)."""
    if is_cpu(x2, "rms_norm"):
        return rms_norm_bwd_plain(x2, weight, rstd, dy, need_dx, need_dw)
    code, w = _check(x2, weight, rstd, dy)
    if dy.shape != x2.shape or dy.dtype != x2.dtype:
        raise ValueError(f"rms_norm backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} does not fit x {x2.dtype} "
                         f"{tuple(x2.shape)}")
    if rstd.dtype != torch.float32 or rstd.numel() != x2.shape[0]:
        raise ValueError(f"rms_norm backward: rstd {rstd.dtype} "
                         f"{tuple(rstd.shape)} is not fp32 [{x2.shape[0]}]")
    if not (need_dx or need_dw):
        return None, None
    from ._build import load_library, zeroed_counters
    rows, H = x2.shape
    rstd, dy = rstd.contiguous(), dy.contiguous()
    dx = torch.empty_like(x2) if need_dx else None
    dw = part = sync = None
    part_rows = 0
    if need_dw:
        part_rows = bwd_plan(x2, w, dy)["blocks"]
        dw = torch.empty(H, dtype=torch.float32, device=x2.device)
        part = torch.empty(part_rows, H, dtype=torch.float32,
                           device=x2.device)
        sync = zeroed_counters("rms_norm_bwd", x2.device, 2)  # grid barrier
    ptr = lambda t: None if t is None else t.data_ptr()
    _launch(f"rms_norm_bwd launch (rows={rows} H={H} {x2.dtype}, dx "
            f"{need_dx}, dw {need_dw})",
            load_library().ptt_rms_norm_bwd, x2.device, x2.data_ptr(),
            w.data_ptr(), rstd.data_ptr(), dy.data_ptr(), ptr(dx), ptr(dw),
            ptr(part), ptr(sync), rows, H, part_rows, code)
    rms_norm_bwd.LAUNCHES += 1
    return dx, dw


for _fn in (rms_norm_fwd, rms_norm_bwd):
    _fn.LAUNCHES = 0


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------
class _RMSNorm(torch.autograd.Function):
    """The ``rms_norm`` custom_vjp: the forward saves (x, weight, rstd); the
    backward forms dx and the fp32 dw in one kernel launch."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        H = x.shape[-1]
        x2 = x.reshape(-1, H).contiguous()
        y, rstd = rms_norm_fwd(x2, weight, epsilon)
        ctx.save_for_backward(x2, weight, rstd)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, weight, rstd = ctx.saved_tensors
        dy2 = dy.reshape(x2.shape).contiguous()
        dx, dw = rms_norm_bwd(x2, weight, rstd, dy2, *ctx.needs_input_grad[:2])
        if dx is not None:
            dx = dx.reshape(dy.shape)
        if dw is not None:
            dw = dw.to(weight.dtype).reshape(weight.shape)
        return dx, dw, None


def rms_norm(x, weight, epsilon=1e-6):
    """y = x / sqrt(mean(x^2) + eps) * weight over the last axis, output in
    x's dtype (an fp32 weight never promotes bf16 rows). Differentiable in
    x and weight; dw comes back in the weight's dtype."""
    return _RMSNorm.apply(x, weight, float(epsilon))
