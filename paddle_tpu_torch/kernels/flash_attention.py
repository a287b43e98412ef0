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
writes ``delta = rowsum(p * dP)`` for the dK/dV kernel, which runs after it:
summed in fp32 from the kernel's own p and dP in a first pass over the keys,
not from the saved output (``rowsum(dO * O)``, as the Pallas kernels form
it), so that each row's dS sums to zero to fp32 rounding even where the
output was rounded to bf16; the backward needs no ``out``.
For bf16 the products run on the tensor cores (warp-level WMMA from bf16
shared tiles, fp32 accumulators, the softmax in fp32 between them); for fp32
on the FP32 pipes from fp32 shared tiles, exact to fp32 rounding.

The forward also takes an additive bias ``[1|B, 1|H, Sq, Sk]`` in q's
dtype, added to the scaled scores before the softmax (``_fwd_kernel`` with
``has_bias``), read in place with stride 0 over its broadcast dims; a row
whose every score the bias pushed to -1e30 gives zeros and ``lse = -1e30``.
The backward with a bias (and the d-bias) is not ported: ``flash_attention``
with a bias runs the forward alone and raises when a gradient is asked for.

Segment ids (``has_seg``, packed rows): int32 ``[B, Sq]`` and ``[B, Sk]``,
a pair visible iff its ids are equal (pad tails carry -1, so pads see pads),
in all three kernels, which skip a tile whose id ranges are disjoint. A row
whose id matches no key is dead (zeros, ``lse = -1e30``, no gradient).

Dropout (``dropout_p``): the keep bit of (batch b, query head h, query i,
key j) is a word of Philox4x32-10 (``philox4x32_10``, the CUDA
``csrc/philox.cuh`` in plain PyTorch) keyed by the 64-bit seed with
``(j // 4, i, h, b)`` as the counter, kept iff it is ``>= floor(p 2^32)``:
a function of (seed, b, h, i, j) alone, so the three kernels, which walk the
scores in different orders, draw the same mask, and the plain versions take
it from ``dropout_keep_mask``. lse comes from the undropped scores; the kept
probabilities are scaled by ``1 / (1 - p)`` (``_fwd_kernel``,
``_dkv_kernel``, ``_dq_kernel``). The forward saves the seed for the
backward. The JAX kernel keys its bits by TPU tile, so the masks of the two
packages differ; their statistics agree.

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

from ._build import is_cpu, launch as _launch

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_plain",
           "philox4x32_10", "dropout_keep_mask", "dropout_threshold",
           "KERNEL_HEAD_DIMS"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# dropout bits: Philox4x32-10 in plain PyTorch (csrc/philox.cuh)
# ---------------------------------------------------------------------------
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """(hi, lo) words of the 64-bit product of the constant ``a`` and the
    uint32 values ``b`` (an int64 tensor), in 16-bit halves so that no
    partial product leaves int64."""
    p1, p2 = a * (b & 0xFFFF), a * (b >> 16)          # each < 2^48
    return (p2 + (p1 >> 16)) >> 16, (((p2 & 0xFFFF) << 16) + p1) & _U32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 over uint32 counters held in int64 tensors (any
    broadcastable shapes) with the key (k0, k1): the four output words, as
    ``csrc/philox.cuh`` computes them on the card."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def dropout_threshold(dropout_p: float) -> int:
    """Keep iff the 32-bit word is >= this (``_dropout_keep``)."""
    return min(int(dropout_p * 2.0 ** 32), 2 ** 32 - 1)


def _seed_words(seed: int):
    seed = int(seed)
    return seed & _U32, (seed >> 32) & _U32


def dropout_keep_mask(seed: int, B: int, H: int, Sq: int, Sk: int,
                      dropout_p: float, device=None) -> torch.Tensor:
    """The kernels' keep-mask, bool [B, H, Sq, Sk]: one Philox call per
    (b, h, i, j // 4) with that tuple as the counter (j // 4 first) and the
    seed's two words as the key; its four words are key columns
    4 (j // 4) .. 4 (j // 4) + 3."""
    n4 = -(-Sk // 4)
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int64)  # noqa: E731
    words = philox4x32_10(ar(n4)[None, None, None, :],
                          ar(Sq)[None, None, :, None],
                          ar(H)[None, :, None, None],
                          ar(B)[:, None, None, None], *_seed_words(seed))
    bits = torch.stack(words, -1).reshape(B, H, Sq, n4 * 4)[..., :Sk]
    return bits >= dropout_threshold(dropout_p)


def _drop_scale(dropout_p):
    return 1.0 / (1.0 - dropout_p)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held to on the card)
# ---------------------------------------------------------------------------
def _scores(q, k, causal, sm_scale, q_seg=None, kv_seg=None):
    """fp32 scores [B, H, Sq, Sk] with k's heads repeated over their group,
    and the visibility mask ([Sq, Sk], or [B, 1, Sq, Sk] with segments)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = (kpos <= qpos + (Sk - Sq)) if causal else torch.ones(
        Sq, Sk, dtype=torch.bool, device=q.device)
    if q_seg is not None:
        ok = ok & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    return s, ok


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float, bias=None,
                    q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                    seed: int = 0):
    """Plain PyTorch forward: (out in q's dtype, lse fp32 [B, H, Sq]);
    ``bias`` (broadcast to [B, H, Sq, Sk]) is added to the scaled scores;
    ``q_seg`` / ``kv_seg`` (int [B, Sq] / [B, Sk]) mask pairs of different
    segments; ``dropout_p`` drops with ``dropout_keep_mask(seed, ...)``."""
    s, ok = _scores(q, k, causal, sm_scale, q_seg, kv_seg)
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
    if bias is not None:
        s = s + bias.float()
    s = s.masked_fill(~ok, _NEG_INF)
    m = s.amax(-1, keepdim=True)
    dead = m <= 0.5 * _NEG_INF                                 # sees no key
    # where, not only the mask: a row the bias kills keeps ok, with p ~ 1
    p = torch.where(ok & ~dead, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    vf = v.float().repeat_interleave(H // Hkv, dim=2)
    prob = p / torch.where(dead, 1.0, l)
    if dropout_p:
        keep = dropout_keep_mask(seed, B, H, Sq, k.shape[1], dropout_p,
                                 q.device)
        prob = torch.where(keep, prob * _drop_scale(dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", prob, vf)
    lse = torch.where(dead, _NEG_INF, m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _bwd_probs(q, k, v, lse, do, causal, sm_scale, q_seg, kv_seg, dropout_p,
               seed):
    """fp32 (p, p kept and rescaled, dP masked and rescaled) [B, H, Sq, Sk]
    from the saved lse, with k and v repeated over their query groups."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    s, ok = _scores(q, k, causal, sm_scale, q_seg, kv_seg)
    live = (lse > 0.5 * _NEG_INF)[..., None]                   # [B, H, Sq, 1]
    # where, not a product: exp(s - lse) overflows on a dead row
    p = torch.where(ok & live, torch.exp(s - lse[..., None]), 0.0)
    vf = v.float().repeat_interleave(g, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    p_kept = p
    if dropout_p:
        keep = dropout_keep_mask(seed, B, H, Sq, Sk, dropout_p, q.device)
        scale_d = _drop_scale(dropout_p)
        p_kept = torch.where(keep, p * scale_d, 0.0)
        dp = torch.where(keep, dp * scale_d, 0.0)
    return p, p_kept, dp


def flash_bwd_plain(q, k, v, lse, do, causal: bool, sm_scale: float,
                    delta=None, q_seg=None, kv_seg=None,
                    dropout_p: float = 0.0, seed: int = 0):
    """Plain PyTorch backward from the saved lse: (dq, dk, dv) in the
    inputs' dtypes, with dk and dv summed over each kv head's query group.
    Segments and dropout as the forward took them: dV takes the kept,
    rescaled p; dP is masked and rescaled before dS = p (dP - delta) scale
    with the undropped p and delta = rowsum(p * dP) in fp32, as the kernels
    form it; ``delta`` ([B, H, Sq] fp32), when given, stands for it."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    p, p_kept, dp = _bwd_probs(q, k, v, lse, do, causal, sm_scale, q_seg,
                               kv_seg, dropout_p, seed)
    if delta is None:
        delta = (p * dp).sum(-1)
    ds = p * (dp - delta[..., None]) * sm_scale
    kf = k.float().repeat_interleave(g, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kept, do.float())
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


def _seg_view(seg, B, S, device, what):
    """Segment ids as the kernels read them: contiguous int32 [B, S] on
    q's device."""
    seg = torch.as_tensor(seg, device=device)
    if seg.shape != (B, S) or seg.is_floating_point():
        raise ValueError(f"{what} must be integer [{B}, {S}], got {seg.dtype} "
                         f"{tuple(seg.shape)}")
    return seg.to(torch.int32).contiguous()


def _variant_args(q, k, q_seg, kv_seg, dropout_p, seed):
    """The C entries' (qseg, kseg, drop, seed0, seed1, thresh, drop_scale)
    and the segment views they point into (kept alive by the caller)."""
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("q_seg and kv_seg go together")
    segs = (None, None)
    if q_seg is not None:
        segs = (_seg_view(q_seg, q.shape[0], q.shape[1], q.device, "q_seg"),
                _seg_view(kv_seg, k.shape[0], k.shape[1], q.device, "kv_seg"))
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    drop = (int(dropout_p > 0), *_seed_words(seed),
            dropout_threshold(dropout_p) if dropout_p else 0,
            _drop_scale(dropout_p) if dropout_p else 1.0)
    ptrs = tuple(None if t is None else t.data_ptr() for t in segs)
    return segs, ptrs, drop


def _tag(q, k, bias, q_seg, dropout_p):
    B, Sq, H, D = q.shape
    extra = "".join((", bias" if bias is not None else "",
                     ", segments" if q_seg is not None else "",
                     f", dropout {dropout_p}" if dropout_p else ""))
    return (f"(B={B} Sq={Sq} Sk={k.shape[1]} H={H} H_kv={k.shape[2]} D={D} "
            f"{q.dtype}{extra})")


def flash_fwd(q, k, v, causal: bool, sm_scale: float, bias=None, q_seg=None,
              kv_seg=None, dropout_p: float = 0.0, seed: int = 0):
    """(out [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq]); ``bias``: an
    additive float mask that broadcasts to [B, H, Sq, Sk], cast to q's
    dtype; ``q_seg`` / ``kv_seg``: integer segment ids [B, Sq] / [B, Sk];
    ``dropout_p`` with the 64-bit ``seed``. A bias does not combine with
    segments or dropout."""
    if is_cpu(q, "flash attention"):
        return flash_fwd_plain(q, k, v, causal, sm_scale, bias, q_seg, kv_seg,
                               dropout_p, seed)
    _check_cuda(q, k, v)
    if bias is not None and (q_seg is not None or dropout_p):
        raise _queue2("a bias with segment ids or dropout")
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    segs, seg_ptrs, drop = _variant_args(q, k, q_seg, kv_seg, dropout_p, seed)
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    bias_ptr, bias_strides = None, (0, 0, 0, 0)
    if bias is not None:
        bias = _bias_view(bias, q, k)
        bias_ptr, bias_strides = bias.data_ptr(), bias.stride()
    _launch(f"flash_fwd launch {_tag(q, k, bias, q_seg, dropout_p)}",
            load_library().ptt_flash_fwd, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), bias_ptr, *seg_ptrs, out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, extra=bias_strides), B, Sq, Sk,
            H, Hkv, D, float(sm_scale), int(causal), *drop,
            _DTYPE_CODE[q.dtype])
    del segs
    flash_fwd.LAUNCHES += 1
    return out, lse


def flash_bwd_dq(q, k, v, lse, do, causal: bool, sm_scale: float,
                 q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                 seed: int = 0):
    """(dq [B, Sq, H, D] in q's dtype, delta = rowsum(p * dP) fp32
    [B, H, Sq])."""
    if is_cpu(q, "flash attention"):
        p, _, dp = _bwd_probs(q, k, v, lse, do, causal, sm_scale, q_seg,
                              kv_seg, dropout_p, seed)
        delta = (p * dp).sum(-1)
        dq = flash_bwd_plain(q, k, v, lse, do, causal, sm_scale, delta=delta,
                             q_seg=q_seg, kv_seg=kv_seg, dropout_p=dropout_p,
                             seed=seed)[0]
        return dq, delta
    _check_cuda(q, k, v, do)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    segs, seg_ptrs, drop = _variant_args(q, k, q_seg, kv_seg, dropout_p, seed)
    lse = lse.contiguous()
    dq = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _launch(f"flash_bwd_dq launch {_tag(q, k, None, q_seg, dropout_p)}",
            load_library().ptt_flash_bwd_dq, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *seg_ptrs, _strides(q, k, v, do), B, Sq, Sk, H, Hkv, D,
            float(sm_scale), int(causal), *drop, _DTYPE_CODE[q.dtype])
    del segs
    flash_bwd_dq.LAUNCHES += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, lse, delta, do, causal: bool, sm_scale: float,
                  q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                  seed: int = 0):
    """(dk, dv) [B, Sk, H_kv, D] in k's dtype, from the ``delta`` that
    ``flash_bwd_dq`` returned."""
    if is_cpu(q, "flash attention"):
        return flash_bwd_plain(q, k, v, lse, do, causal, sm_scale,
                               delta=delta, q_seg=q_seg, kv_seg=kv_seg,
                               dropout_p=dropout_p, seed=seed)[1:]
    _check_cuda(q, k, v, do)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    segs, seg_ptrs, drop = _variant_args(q, k, q_seg, kv_seg, dropout_p, seed)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(B, Sk, Hkv, D, dtype=k.dtype, device=k.device)
    dv = torch.empty(B, Sk, Hkv, D, dtype=v.dtype, device=v.device)
    _launch(f"flash_bwd_dkv launch {_tag(q, k, None, q_seg, dropout_p)}",
            load_library().ptt_flash_bwd_dkv, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *seg_ptrs, _strides(q, k, v, do), B, Sq, Sk, H, Hkv, D,
            float(sm_scale), int(causal), *drop, _DTYPE_CODE[q.dtype])
    del segs
    flash_bwd_dkv.LAUNCHES += 1
    return dk, dv


def flash_bwd(q, k, v, lse, do, causal: bool, sm_scale: float,
              q_seg=None, kv_seg=None, dropout_p: float = 0.0, seed: int = 0):
    """(dq, dk, dv): the dQ kernel (which also forms delta), then the dK/dV
    kernel; on the CPU, the plain backward."""
    if is_cpu(q, "flash attention"):
        return flash_bwd_plain(q, k, v, lse, do, causal, sm_scale,
                               q_seg=q_seg, kv_seg=kv_seg,
                               dropout_p=dropout_p, seed=seed)
    variant = dict(q_seg=q_seg, kv_seg=kv_seg, dropout_p=dropout_p, seed=seed)
    dq, delta = flash_bwd_dq(q, k, v, lse, do, causal, sm_scale,
                             **variant)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, sm_scale,
                           **variant)
    return dq, dk, dv


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.LAUNCHES = 0


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: the forward saves (q, k, v, lse) and the
    segment ids, and keeps the dropout seed; the backward runs the two
    backward kernels from them. q, k and v are saved as the caller's views
    (for the model, views of its kept ``qkv``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_seg, kv_seg, dropout_p,
                seed):
        out, lse = flash_fwd(q, k, v, causal, sm_scale, q_seg=q_seg,
                             kv_seg=kv_seg, dropout_p=dropout_p, seed=seed)
        ctx.save_for_backward(q, k, v, lse, q_seg, kv_seg)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.dropout_p, ctx.seed = dropout_p, seed
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, q_seg, kv_seg = ctx.saved_tensors
        # dO arrives contiguous from the model; a stray layout is copied once
        dq, dk, dv = flash_bwd(q, k, v, lse, do.contiguous(),
                               ctx.causal, ctx.sm_scale, q_seg=q_seg,
                               kv_seg=kv_seg, dropout_p=ctx.dropout_p,
                               seed=ctx.seed)
        return dq, dk, dv, None, None, None, None, None, None


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
    Differentiable in query, key and value.

    ``q_segment_ids`` / ``kv_segment_ids``: integer [B, Sq] / [B, Sk]
    packed-varlen ids, both or neither. ``dropout_p`` > 0 needs
    ``dropout_seed`` (an int; the forward and backward draw the same mask
    from it). ``bias``: an additive float mask that broadcasts to
    [B, H, Sq, Sk] (use 0 / -1e30 for a bool mask), a constant; with a bias
    the call is forward only and raises NotImplementedError when grad mode
    is on and an input requires grad, and a bias does not combine with
    segments or dropout. The flashmask and window variants and
    ``bias_grad`` raise NotImplementedError."""
    for name, val in (("startend_row_indices", startend_row_indices),
                      ("window", window)):
        if val is not None:
            raise _queue2(name)
    if bias_grad:
        raise _queue2("bias_grad")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("flash_attention: q_segment_ids and kv_segment_ids "
                         "go together")
    dropout_p = float(dropout_p)
    if dropout_p and dropout_seed is None:
        raise ValueError("flash_attention: dropout_p > 0 requires "
                         "dropout_seed")
    seed = 0 if dropout_seed is None else int(dropout_seed)
    d = query.shape[-1]
    scale = float(sm_scale) if sm_scale is not None else 1.0 / math.sqrt(d)
    if bias is not None:
        if q_segment_ids is not None or dropout_p:
            raise _queue2("a bias with segment ids or dropout")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (query, key, value)):
            raise _queue2("the backward with a bias")
        return flash_fwd(query, key, value, bool(causal), scale, bias)[0]
    q_seg = kv_seg = None
    if q_segment_ids is not None:
        q_seg = _seg_view(q_segment_ids, query.shape[0], query.shape[1],
                          query.device, "q_segment_ids")
        kv_seg = _seg_view(kv_segment_ids, key.shape[0], key.shape[1],
                           query.device, "kv_segment_ids")
    return _Flash.apply(query, key, value, bool(causal), scale, q_seg, kv_seg,
                        dropout_p, seed)
