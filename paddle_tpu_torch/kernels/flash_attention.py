"""Flash attention forward and backward (counterpart:
``paddle_tpu/kernels/pallas/flash_attention.py`` ``flash_attention``, the
``jax.custom_vjp`` ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``, and the three
kernels ``_fwd`` (``_fwd_kernel``), ``_bwd_impl``'s dK/dV (``_dkv_kernel``)
and dQ (``_dq_kernel``)).

The TPU kernels are replaced by CUDA kernels written by hand for Hopper:
``paddle_tpu_torch/csrc/flash_attention_fwd.cu`` (the forward) and
``paddle_tpu_torch/csrc/flash_attention_bwd.cu`` (dQ, then dK/dV). Their
source notes state the design; in short: one CUDA block per (64-row tile,
head, batch) loops over the other side's tiles itself, keeps the online
softmax state and its output tile in registers, skips the tiles past the
causal diagonal by its loop bound, and reads q, k and v as strided
``[B, S, H, D]`` views, so the model's head-major ``qkv`` is never copied.
GQA indexes kv head ``h // (H // H_kv)``; the dK/dV kernel sums a group's
query heads inside one block (no atomics: deterministic). The dQ kernel also
writes ``delta = rowsum(dO * O)`` for the dK/dV kernel, which runs after it.
For bf16 the products run on the tensor cores (warp-level WMMA from bf16
shared tiles, fp32 accumulators, the softmax in fp32 between them); for fp32
on the FP32 pipes from fp32 shared tiles, exact to fp32 rounding.

The forward also takes an additive bias ``[1|B, 1|H, Sq, Sk]`` in q's
dtype, added to the scaled scores before the softmax (``_fwd_kernel`` with
``has_bias``), read in place with stride 0 over its broadcast dims; a row
whose every score the bias pushed to -1e30 gives zeros and ``lse = -1e30``.
The backward with a bias (and the d-bias) is not ported: ``flash_attention``
with a bias runs the forward alone and raises when a gradient is asked for.

Wrappers: ``flash_fwd`` (out, lse), ``flash_bwd_dq`` (dq, delta) and
``flash_bwd_dkv`` (dk, dv), and ``flash_bwd`` (both, in order). A CUDA tensor
goes to the kernel or the call raises; a CPU tensor goes to the plain PyTorch
version (``flash_fwd_plain``, ``flash_bwd_plain``). Each wrapper counts its
kernel launches in ``.LAUNCHES``.

Layouts: q ``[B, Sq, H, D]``, k and v ``[B, Sk, H_kv, D]`` (any strides with a
unit stride over D), out and the gradients contiguous in the inputs' layout,
lse and delta fp32 ``[B, H, Sq]``. Causal masking is bottom-right aligned
(key j is visible to query i iff ``j <= i + Sk - Sq``); a query row that sees
no key gives zeros and ``lse = -1e30``. Any Sq and Sk; the kernels take D in
{64, 128} and fp32 or bf16.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_plain",
           "KERNEL_HEAD_DIMS"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to on the card)
# ---------------------------------------------------------------------------
def _scores(q, k, causal, sm_scale):
    """fp32 scores [B, H, Sq, Sk] with k's heads repeated over their group,
    and the visibility mask [Sq, Sk]."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = (kpos <= qpos + (Sk - Sq)) if causal else torch.ones(
        Sq, Sk, dtype=torch.bool, device=q.device)
    return s, ok


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float, bias=None):
    """Plain PyTorch forward: (out in q's dtype, lse fp32 [B, H, Sq]);
    ``bias`` (broadcast to [B, H, Sq, Sk]) is added to the scaled scores."""
    s, ok = _scores(q, k, causal, sm_scale)
    H, Hkv = q.shape[2], k.shape[2]
    if bias is not None:
        s = s + bias.float()
    s = s.masked_fill(~ok, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    dead = m <= 0.5 * _NEG_INF                                 # sees no key
    # where, not only the mask: a row the bias kills keeps ok, with p ~ 1
    p = torch.where(ok & ~dead, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.where(dead, 1.0, l), vf)
    lse = torch.where(dead, _NEG_INF, m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _delta_plain(out, do):
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, out, lse, do, causal: bool, sm_scale: float,
                    delta=None):
    """Plain PyTorch backward from the saved (out, lse): (dq, dk, dv) in the
    inputs' dtypes, with dk and dv summed over each kv head's query group.
    ``delta`` ([B, H, Sq] fp32), when given, stands for rowsum(dO * out)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    s, ok = _scores(q, k, causal, sm_scale)
    live = (lse > 0.5 * _NEG_INF)[..., None]                   # [B, H, Sq, 1]
    # where, not a product: exp(s - lse) overflows on a dead row
    p = torch.where(ok & live, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    vf = v.float().repeat_interleave(g, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    if delta is None:
        delta = _delta_plain(out, do)
    ds = p * (dp - delta[..., None]) * sm_scale
    kf = k.float().repeat_interleave(g, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Sk, Hkv, g, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, g, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _strides(*ts, extra=()):
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    vals += list(extra)
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_cuda(q, k, v, *more):
    """What the kernels take: 4-D [B, S, H, D] views on one card, one dtype
    (fp32 or bf16), a unit stride over D, 16-byte aligned bases and strides,
    D in KERNEL_HEAD_DIMS, H a multiple of H_kv."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of H_kv={k.shape[2]}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take D in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    for i, t in enumerate((q, k, v) + more):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"input {i} is {t.dtype} on {t.device}; q is "
                            f"{q.dtype} on {q.device}")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"input {i} needs a unit stride over D (strides "
                             f"{t.stride()})")
        it = t.element_size()
        if t.data_ptr() % 16 or any(s * it % 16 for s in t.stride()[:3]):
            raise ValueError(f"input {i}: base and strides must be 16-byte "
                             f"aligned (strides {t.stride()})")


def _launch(what, fn, device, *args):
    from ._build import check
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    check(code, what)


def _is_cpu(t):
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {t.device}")
    return False


def _bias_view(bias, q, k):
    """The bias in q's dtype as a [B, H, Sq, Sk] view: stride 0 over its
    broadcast dims (``expand`` copies nothing)."""
    B, Sq, H, _ = q.shape
    full = (B, H, Sq, k.shape[1])
    if (bias.dim() > 4 or not bias.is_floating_point() or any(
            n not in (1, m) for n, m in zip(bias.shape[::-1], full[::-1]))):
        raise ValueError(f"bias must be a float mask that broadcasts to "
                         f"{list(full)}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if bias.device != q.device:
        raise ValueError(f"bias is on {bias.device}, q on {q.device}")
    return bias.to(q.dtype).expand(full)


def flash_fwd(q, k, v, causal: bool, sm_scale: float, bias=None):
    """(out [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq]); ``bias``: an
    additive float mask that broadcasts to [B, H, Sq, Sk], cast to q's
    dtype."""
    if _is_cpu(q):
        return flash_fwd_plain(q, k, v, causal, sm_scale, bias)
    _check_cuda(q, k, v)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    what = (f"flash_fwd launch (B={B} Sq={Sq} Sk={Sk} H={H} H_kv={Hkv} "
            f"D={D} {q.dtype}{', bias' if bias is not None else ''})")
    bias_ptr, bias_strides = None, (0, 0, 0, 0)
    if bias is not None:
        bias = _bias_view(bias, q, k)
        bias_ptr, bias_strides = bias.data_ptr(), bias.stride()
    _launch(what, load_library().ptt_flash_fwd, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, extra=bias_strides), B, Sq, Sk,
            H, Hkv, D, float(sm_scale), int(causal), _DTYPE_CODE[q.dtype])
    flash_fwd.LAUNCHES += 1
    return out, lse


def flash_bwd_dq(q, k, v, out, lse, do, causal: bool, sm_scale: float):
    """(dq [B, Sq, H, D] in q's dtype, delta fp32 [B, H, Sq])."""
    if _is_cpu(q):
        dq = flash_bwd_plain(q, k, v, out, lse, do, causal, sm_scale)[0]
        return dq, _delta_plain(out, do)
    _check_cuda(q, k, v, out, do)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    lse = lse.contiguous()
    dq = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _launch(f"flash_bwd_dq launch (B={B} Sq={Sq} Sk={Sk} H={H} H_kv={Hkv} "
            f"D={D} {q.dtype})", load_library().ptt_flash_bwd_dq, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, out, do), B, Sq, Sk, H, Hkv, D,
            float(sm_scale), int(causal), _DTYPE_CODE[q.dtype])
    flash_bwd_dq.LAUNCHES += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, do, causal: bool, sm_scale: float):
    """(dk, dv) [B, Sk, H_kv, D] in k's dtype, from the ``delta`` that
    ``flash_bwd_dq`` returned."""
    if _is_cpu(q):
        return flash_bwd_plain(q, k, v, None, lse, do, causal, sm_scale,
                               delta=delta)[1:]
    _check_cuda(q, k, v, do)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(B, Sk, Hkv, D, dtype=k.dtype, device=k.device)
    dv = torch.empty(B, Sk, Hkv, D, dtype=v.dtype, device=v.device)
    _launch(f"flash_bwd_dkv launch (B={B} Sq={Sq} Sk={Sk} H={H} H_kv={Hkv} "
            f"D={D} {q.dtype})", load_library().ptt_flash_bwd_dkv, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, do), B, Sq, Sk, H, Hkv, D,
            float(sm_scale), int(causal), _DTYPE_CODE[q.dtype])
    flash_bwd_dkv.LAUNCHES += 1
    return dk, dv


def flash_bwd(q, k, v, out, lse, do, causal: bool, sm_scale: float):
    """(dq, dk, dv): the dQ kernel (which also forms delta), then the dK/dV
    kernel; on the CPU, the plain backward."""
    if _is_cpu(q):
        return flash_bwd_plain(q, k, v, out, lse, do, causal, sm_scale)
    dq, delta = flash_bwd_dq(q, k, v, out, lse, do, causal, sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, sm_scale)
    return dq, dk, dv


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.LAUNCHES = 0


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: the forward saves (q, k, v, out, lse), the
    backward runs the two backward kernels from them. q, k and v are saved
    as the caller's views (for the model, views of its kept ``qkv``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # dO arrives contiguous from the model; a stray layout is copied once
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def _queue2(what):
    return NotImplementedError(
        f"flash_attention: {what} is not ported yet (ROADMAP Queue 2 #2, "
        f"the flash kernel's variants)")


def flash_attention(query, key, value, causal=False, sm_scale=None, *,
                    bias=None, q_segment_ids=None, kv_segment_ids=None,
                    startend_row_indices=None, window=None, dropout_p=0.0,
                    dropout_seed=None, bias_grad=False):
    """Fused attention. query [B, Sq, H, D]; key / value [B, Sk, H_kv, D]
    with H % H_kv == 0 (GQA indexed, never repeated) -> [B, Sq, H, D].
    Differentiable in query, key and value. ``bias``: an additive float mask
    that broadcasts to [B, H, Sq, Sk] (use 0 / -1e30 for a bool mask), a
    constant; with a bias the call is forward only and raises
    NotImplementedError when grad mode is on and an input requires grad.
    The segment-id, flashmask, window and dropout variants raise
    NotImplementedError."""
    del dropout_seed
    for name, val in (("q_segment_ids", q_segment_ids),
                      ("kv_segment_ids", kv_segment_ids),
                      ("startend_row_indices", startend_row_indices),
                      ("window", window)):
        if val is not None:
            raise _queue2(name)
    if dropout_p:
        raise _queue2("dropout_p > 0")
    if bias_grad:
        raise _queue2("bias_grad")
    d = query.shape[-1]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    if bias is not None:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (query, key, value)):
            raise _queue2("the backward with a bias")
        return flash_fwd(query, key, value, bool(causal), scale, bias)[0]
    return _Flash.apply(query, key, value, bool(causal), scale)
