"""Fused LayerNorm, forward and backward (counterpart:
``paddle_tpu/kernels/pallas/layer_norm.py`` ``layer_norm``, the
``jax.custom_vjp`` ``_ln`` / ``_ln_fwd`` / ``_ln_bwd``, kernel bodies
``_fwd_kernel`` and ``_bwd_kernel``, and the dw / db reduction the JAX
backward leaves to XLA).

The TPU kernels are replaced by CUDA kernels written by hand for Hopper,
``paddle_tpu_torch/csrc/layer_norm.cu``; its source note states the design.
The forward computes the statistics and the affine in fp32 and rounds once
to x's dtype, as the Pallas kernel does (the composed op rounds before its
affine; at fp32 the two agree). It saves ``mean`` and ``rstd`` as fp32
``[rows]``. Where the row is whole aligned 16-byte words of at most 8 a
lane (bf16 / fp16 H <= 2048, fp32 H <= 1024) it is a persistent grid whose
warps hold the row in registers, two row buffers each, with the weight and
bias in registers or the block's shared memory; other rows take one warp a
row, any width (``fwd_plan`` says which). The backward forms dx and,
in the same launch, the fp32 cross-row sums dw = sum(dy * xhat) and db =
sum(dy) (a cooperative launch; each block's partials in registers or a
column-tiled workspace row, folded over the grid in a fixed order, so two
calls give the same bits). A bias-less call forms no db, a frozen weight
with no trainable bias takes the dx-only kernel, a frozen x skips the dx
stores. The autograd Function rounds dw and db once to the parameters'
dtypes.

Wrappers: ``layer_norm_fwd`` (y, mean, rstd) and ``layer_norm_bwd`` (dx, dw,
db), each counting its kernel launches in ``.LAUNCHES``
(``layer_norm_bwd.ROUTES`` counts them by route); ``fwd_plan`` and
``bwd_plan`` report the forward's and the backward's route and grid. The
tile primitives' LayerNorm runs the same kernels through ``launch_fwd`` and
``launch_bwd``, which count nothing (each caller counts its own launches).
A CUDA tensor goes to the kernel or the call raises; a CPU tensor goes to
the plain PyTorch version
(``layer_norm_fwd_plain``, ``layer_norm_bwd_plain``). ``layer_norm`` is the
differentiable public function over a ``torch.autograd.Function``.
"""

from __future__ import annotations

import functools

import torch

from ._build import check_rows, is_cpu, launch as _launch

__all__ = ["layer_norm", "layer_norm_fwd", "layer_norm_bwd", "fwd_plan",
           "bwd_plan", "layer_norm_fwd_plain", "layer_norm_bwd_plain",
           "launch_fwd", "launch_bwd"]

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


def layer_norm_bwd_plain(x2, weight, mean, rstd, dy, has_bias=True,
                         need_dx=True, need_dw=True):
    """(dx in x2's dtype, dw fp32 [H], db fp32 [H]) from the saved
    statistics; None for what is not needed (db without a bias). dw and db
    are the cross-row reductions the JAX backward leaves to XLA (fp32)."""
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    dyf = dy.float()
    dx = None
    if need_dx:
        dxhat = dyf * weight.float().reshape(-1)
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        dx = (rstd[:, None] * (dxhat - m1 - xhat * m2)).to(x2.dtype)
    dw = (dyf * xhat).sum(0) if need_dw else None
    db = dyf.sum(0) if has_bias else None
    return dx, dw, db


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


@functools.lru_cache(maxsize=256)
def _plan(device_index, rows, H, code, aligned, need_dw, need_db,
          forward=False):
    import ctypes
    from ._build import check, load_library
    out = (ctypes.c_int * 2)()
    lib = load_library()
    with torch.cuda.device(device_index):
        if forward:
            status = lib.ptt_layer_norm_fwd_plan(rows, H, code, int(aligned),
                                                 out)
        else:
            status = lib.ptt_layer_norm_bwd_plan(rows, H, code, int(aligned),
                                                 int(need_dw), int(need_db),
                                                 out)
        check(status, f"layer_norm {'forward' if forward else 'backward'} "
              f"plan (rows={rows} H={H})")
    other = "walk" if forward else "tiled"
    return dict(path="held" if out[0] else other, blocks=out[1])


def fwd_plan(x2, weight, bias=None, y=None) -> dict:
    """The forward's route for these CUDA tensors (no data is read): ``path``
    "held" (a persistent grid, the row in registers) or "walk" (one warp a
    row, the row read again), and ``blocks``, the grid."""
    code = check_rows(x2, "layer_norm", weight)
    rows, H = x2.shape
    w = _affine(weight, H, "weight")
    b = None if bias is None else _affine(bias, H, "bias")
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x2, w, b, y) if t is not None)
    return _plan(x2.device.index, rows, H, code, aligned, False, False, True)


def bwd_plan(x2, weight, dy=None, dx=None, need_dw=True,
             need_db=True) -> dict:
    """The backward's route for these CUDA tensors (no data is read):
    ``path`` "held" (the row in registers, dw / db partials in registers),
    "tiled" (any width: a column-tiled partial) or "dx-only" (neither sum
    asked for), and ``blocks``, the grid (for a sum, of the cooperative
    launch and the rows of its workspace)."""
    code = check_rows(x2, "layer_norm", weight)
    rows, H = x2.shape
    if not (need_dw or need_db):
        return dict(path="dx-only", blocks=-(-rows // 8))
    w = _affine(weight, H, "weight")
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (x2, w, dy, dx) if t is not None)
    return _plan(x2.device.index, rows, H, code, aligned, bool(need_dw),
                 bool(need_db))


def launch_bwd(x2, weight, mean, rstd, dy, need_dx=True, need_dw=True,
               need_db=True):
    """The backward kernel on a CUDA ``x2``: (dx, dw, db, route), None for
    what is not needed; uncounted (each caller counts its own launches; the
    tile primitives' LayerNorm runs it too)."""
    code = check_rows(x2, "layer_norm", weight, mean, rstd, dy)
    if dy.shape != x2.shape or dy.dtype != x2.dtype:
        raise ValueError(f"layer_norm backward: dy {dy.dtype} "
                         f"{tuple(dy.shape)} does not fit x {x2.dtype} "
                         f"{tuple(x2.shape)}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.dtype != torch.float32 or t.numel() != x2.shape[0]:
            raise ValueError(f"layer_norm backward: {name} {t.dtype} "
                             f"{tuple(t.shape)} is not fp32 [{x2.shape[0]}]")
    from ._build import load_library, zeroed_counters
    rows, H = x2.shape
    w = _affine(weight, H, "weight")
    mean, rstd, dy = mean.contiguous(), rstd.contiguous(), dy.contiguous()
    dx = torch.empty_like(x2) if need_dx else None
    plan = bwd_plan(x2, w, dy, dx, need_dw, need_db)
    nsum = int(bool(need_dw)) + int(bool(need_db))
    sums = part = sync = None
    if nsum:
        sums = torch.empty(nsum * H, dtype=torch.float32, device=x2.device)
        part = torch.empty(plan["blocks"], nsum * H, dtype=torch.float32,
                           device=x2.device)
        sync = zeroed_counters("layer_norm_bwd", x2.device, 2)  # grid barrier
    ptr = lambda t: None if t is None else t.data_ptr()
    _launch(f"layer_norm_bwd launch (rows={rows} H={H} {x2.dtype}, dx "
            f"{need_dx}, dw {need_dw}, db {need_db})",
            load_library().ptt_layer_norm_bwd, x2.device, x2.data_ptr(),
            w.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
            ptr(dx), ptr(sums), ptr(part), ptr(sync), rows, H, int(need_dw),
            int(need_db), plan["blocks"] if nsum else 0, code)
    dw = sums[:H] if need_dw else None
    db = sums[nsum * H - H:] if need_db else None
    return dx, dw, db, plan["path"]


def layer_norm_bwd(x2, weight, mean, rstd, dy, need_dx=True, need_dw=True,
                   need_db=True):
    """(dx [rows, H] in x2's dtype, dw fp32 [H], db fp32 [H]) from the
    forward's statistics, in one launch; None for what is not needed
    (``need_db`` False for a bias-less call)."""
    if is_cpu(x2, "layer_norm"):
        return layer_norm_bwd_plain(x2, weight, mean, rstd, dy, need_db,
                                    need_dx, need_dw)
    if not (need_dx or need_dw or need_db):
        return None, None, None
    dx, dw, db, path = launch_bwd(x2, weight, mean, rstd, dy, need_dx,
                                  need_dw, need_db)
    layer_norm_bwd.LAUNCHES += 1
    layer_norm_bwd.ROUTES[path] += 1
    return dx, dw, db


for _fn in (layer_norm_fwd, layer_norm_bwd):
    _fn.LAUNCHES = 0
layer_norm_bwd.ROUTES = {"held": 0, "tiled": 0, "dx-only": 0}


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------
class _LayerNorm(torch.autograd.Function):
    """The ``_ln`` custom_vjp: the forward saves (x, weight, mean, rstd);
    the backward forms dx and the fp32 dw (and db) in one kernel launch."""

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
        need_dx, need_dw, need_db = ctx.needs_input_grad[:3]
        dx, dw, db = layer_norm_bwd(x2, weight, mean, rstd, dy2, need_dx,
                                    need_dw, ctx.has_bias and need_db)
        if dx is not None:
            dx = dx.reshape(dy.shape)
        if dw is not None:
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
