"""Fused rotary position embedding (counterpart:
``paddle_tpu/kernels/pallas/rope.py`` ``apply_rope``, the ``jax.custom_vjp``
over ``_rope_call``, kernel body ``_rope_kernel``).

NeoX / Llama half-split convention: x = [x1, x2] halves of the head dim,
``rot(x) = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]`` with cos and sin
``[S, D/2]``, in fp32, rounded once to x's dtype. The backward is the
inverse rotation, the same kernel with ``neg_sin``; the tables get no
gradient.

The TPU kernel is replaced by a CUDA kernel written by hand for Hopper,
``paddle_tpu_torch/csrc/rope.cu``; its source note states the design: one
16-byte word of each half a thread, x read once and y written once, x
strided over B, S and H in place (a ``.contiguous()`` copy would be a
hidden pass; only a D that is not contiguous, such as the expanded
cotangent of a sum, is copied first). The wrapper ``rope`` counts its
kernel launches in ``.LAUNCHES``. A CUDA tensor goes to the kernel or the
call raises; a CPU tensor goes to the plain PyTorch version
``rope_plain``. ``apply_rope`` is the differentiable public function.
"""

from __future__ import annotations

import torch

from ._build import dtype_code, is_cpu, launch as _launch

__all__ = ["apply_rope", "supported", "rope", "rope_plain", "rotate"]

def supported(x, cos, sin, **kwargs) -> bool:
    """The Pallas module's gate: 4-D ``[B, S, H, D]`` with an even D."""
    del cos, sin, kwargs
    return x.dim() == 4 and x.shape[-1] % 2 == 0


def _tables(x, cos, sin):
    """cos and sin as fp32 ``[S, D/2]`` (the Pallas call reshapes them to
    that; a table of another size raises)."""
    S, half = x.shape[1], x.shape[-1] // 2
    out = []
    for t in (cos, sin):
        if t.numel() != S * half:
            raise ValueError(f"rope: a table has shape {tuple(t.shape)}, x "
                             f"{tuple(x.shape)} needs [S, D/2] = "
                             f"[{S}, {half}]")
        out.append(t.reshape(S, half).float())
    return out


def rotate(x, c, s):
    """The half-split rotation of x [B, S, H, D] by tables that broadcast
    against [B, S, H, D/2], in fp32, rounded once to x's dtype: the plain
    version below, and the composed rotations of ``models/llama.py`` and
    incubate's ``fused_rotary_position_embedding``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def rope_plain(x, cos, sin, neg_sin=False):
    """The kernel's arithmetic on x [B, S, H, D] with [S, D/2] tables."""
    c, s = _tables(x, cos, sin)
    if neg_sin:
        s = -s
    return rotate(x, c[None, :, None, :], s[None, :, None, :])


def rope(x, cos, sin, neg_sin=False):
    """y [B, S, H, D] (contiguous, x's dtype) = x rotated by (cos, ±sin).
    x is read in place over B, S and H; a D that is not contiguous is copied
    first."""
    if not supported(x, cos, sin):
        raise ValueError(f"rope takes [B, S, H, D] with an even D, got "
                         f"{tuple(x.shape)}")
    if is_cpu(x, "rope"):
        return rope_plain(x, cos, sin, neg_sin)
    code = dtype_code(x, "rope")
    if x.stride(-1) != 1:     # the kernel reads D in place: one copy here
        x = x.contiguous()
    c, s = (t.contiguous() for t in _tables(x, cos, sin))
    for t in (c, s):
        if t.device != x.device:
            raise ValueError(f"rope: a table is on {t.device}, x on "
                             f"{x.device}")
    from ._build import load_library
    B, S, H, D = x.shape
    y = torch.empty((B, S, H, D), dtype=x.dtype, device=x.device)
    _launch(f"rope launch ({tuple(x.shape)} {x.dtype} neg_sin={neg_sin})",
            load_library().ptt_rope, x.device, x.data_ptr(), c.data_ptr(),
            s.data_ptr(), y.data_ptr(), B, S, H, D, x.stride(0), x.stride(1),
            x.stride(2), int(bool(neg_sin)), code)
    rope.LAUNCHES += 1
    return y


rope.LAUNCHES = 0


class _Rope(torch.autograd.Function):
    """The ``apply_rope`` custom_vjp: the backward rotates the cotangent by
    (cos, -sin) with the same kernel; no gradient for the tables."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return rope(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        return rope(g, cos, sin, neg_sin=True), None, None


def apply_rope(x, cos, sin):
    """x [B, S, H, D]; cos, sin [S, D/2]. Rotates the half-split head dim
    by position-dependent angles; differentiable in x."""
    return _Rope.apply(x, cos, sin)
