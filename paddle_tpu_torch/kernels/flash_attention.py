"""Flash attention forward and backward (counterpart:
``paddle_tpu/kernels/pallas/flash_attention.py`` ``flash_attention``, the
``jax.custom_vjp`` ``_flash`` / ``_flash_fwd`` / ``_flash_bwd``, and the three
kernels ``_fwd`` (``_fwd_kernel``), ``_bwd_impl``'s dK/dV (``_dkv_kernel``)
and dQ (``_dq_kernel``)).

The TPU kernels are replaced by CUDA kernels written by hand for Hopper,
behind the C entries of ``csrc/flash_attention.cu``, which route every
call (its head note states what the backward computes and why). Their
source notes state the
design; in short: one CUDA block per (64-row tile, head, batch) loops over
the other side's tiles itself, keeps the online softmax state and its
output tile in registers, skips the tiles past the causal diagonal by its
loop bound, and reads q, k and v as strided ``[B, S, H, D]`` views, so the
model's head-major ``qkv`` is never copied. GQA indexes kv head
``h // (H // H_kv)``; the dK/dV kernel sums a group's query heads inside one
block (no atomics: deterministic). The dQ kernel also writes
``delta = rowsum(p * dP)`` for the dK/dV kernel, which runs after it: summed
in fp32 from the kernel's own p and dP in a first pass over the keys, not
from the saved output (``rowsum(dO * O)``, as the Pallas kernels form it),
so that each row's dS sums to zero to fp32 rounding even where the output
was rounded to 16 bits; the backward needs no ``out``. For bf16 and fp16 the
products run on the tensor cores through ``wgmma``: the forward and dQ
kernels with the scores, probabilities and accumulators in registers and
K / V fed by a TMA ring (``csrc/flash_fwd_hopper.cu``,
``csrc/flash_dq_hopper.cu``), the dK/dV kernel with the transposed scores
in registers and Q / dO fed by a TMA ring (``csrc/flash_dkv_hopper.cu``; at
D_pad 192 and 256 one warpgroup holds dv and another dk over the same 64
keys); fp32 accumulators and the softmax in fp32 either way.
``kernel_plan`` says which design and which tiles serve a call. In fp32
every kernel runs on the TF32 tensor cores (``csrc/flash_fwd_tf32_hopper.cu``:
blocks of 128 query rows over 32-key tiles up to D_pad 128, of 64 rows over
16-key tiles at 192 and 256, V transposed in shared memory so that p stays
in registers; ``csrc/flash_dq_tf32_hopper.cu``,
``csrc/flash_dkv_tf32_hopper.cu``: dQ blocks of 64 query rows over key
tiles of 32 up to D_pad 192 and of 16 at 256, dK/dV blocks of 64 keys over
query tiles of 32 up to D_pad 128 and of 16 at 192 and 256): each fp32
operand is split into two TF32 halves,
hi = T(x) and lo = T(x - hi), and each product is taken as a_lo b_hi +
a_hi b_lo + a_hi b_hi in fp32 accumulators, about 2^-21 of a product
against TF32's 2^-11 (held to the plain versions at 5e-6 on the worst
64-row tile by ``chip_smoke.py``). The backward draws the forward's dropout
bits (the keep bit is a function of (seed, b, h, i, j) alone).

Head dims and dtypes. The kernels take every D from 1 to 256 (the JAX
gate's ``supported``: D <= 256) in fp32, bf16 and fp16; any other dtype
raises TypeError, a larger D ValueError (``nn.functional``'s
``scaled_dot_product_attention`` sends D > 256 to the composed path by
shape, as the JAX registry does). They are compiled for a family of padded
widths (``_build.FLASH_D_PADS``) and load a head of width D into the next
one with zero columns, which add nothing to ``q k^T``; the columns past D of
out, dq, dk and dv are never stored. A head whose row is not a whole number of
16-byte words (D 33 in bf16, D 5 in fp32) is copied once, in the wrapper,
into a zero-padded contiguous buffer of the next such width before the
launch, and the outputs are cut back to D: a layout step, not a fallback.

Additive bias ``[1|B, 1|H, Sq, Sk]`` (``has_bias``): added in fp32 to the
scaled scores before the softmax in all three kernels, read in place with
stride 0 over its broadcast dims and in its own dtype (fp32, bf16 or fp16),
as ``_mask_scores`` adds ``bias.astype(float32)``; a bool keep-mask becomes
``where(mask, 0, -1e30)`` in q's dtype (``register.py`` ``_sdpa_pallas``).
A row whose every score the bias pushed to -1e30 gives zeros, ``lse =
-1e30`` and no gradient. The bias combines with segments and dropout. With
``bias_grad`` the dQ kernel also writes the d-bias, ``dS`` without the
scale, fp32 ``[B, H, Sq, Sk]`` (zeros on the tiles it skips), which the
wrapper sums over the bias's broadcast dims and casts to its dtype
(``_dq_kernel``'s ``bias_grad`` branch, ``_flash_bwd``); without it the bias
is a constant.

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

Flashmask rows (``startend_row_indices=(start, end)``, ``fm`` below):
integer ``[B, 1|H, Sk]``; key column j of (batch b, query head h) is masked
for the raw query index ``start[j] <= i < end[j]`` (not offset-aligned, as
``_mask_scores``), with GQA indexed by query head. ``flash_attention``
converts them once to contiguous int32 on q's device. All three kernels
load a key tile's 64 pairs and skip a tile whose every pair lies inside the
rows' bands (exact). A row whose every key is masked is dead (zeros,
``lse = -1e30``, no gradient); the rows get no gradient.

Sliding window (``window=(left, right)``): key j is visible to query i iff
``i + off - left <= j <= i + off + right`` with ``off = Sk - Sq``
(bottom-right aligned, like causal); a negative or None side is open and
``(None, None)`` is no window (``_norm_window``, as JAX's
``flash_attention`` normalizes it). The kernels walk only the band's tiles.
The rows and the window combine with causal masking, a bias, segments and
dropout.

Wrappers: ``flash_fwd`` (out, lse), ``flash_bwd_dq`` (dq, delta, and the
full d-bias with ``bias_grad``) and ``flash_bwd_dkv`` (dk, dv), and
``flash_bwd`` (all, in order). A CUDA tensor goes to the kernel or the call
raises; a CPU tensor goes to the plain PyTorch version (``flash_fwd_plain``,
``flash_bwd_plain``). Each wrapper counts its kernel launches in
``.LAUNCHES``.

Layouts: q ``[B, Sq, H, D]``, k and v ``[B, Sk, H_kv, D]`` (any strides with a
unit stride over D), out and the gradients contiguous in the inputs' layout,
lse and delta fp32 ``[B, H, Sq]``. Causal masking is bottom-right aligned
(key j is visible to query i iff ``j <= i + Sk - Sq``); a query row that sees
no key gives zeros and ``lse = -1e30``. Any Sq and Sk.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import is_cpu, launch as _launch

__all__ = ["flash_attention", "flash_fwd", "flash_bwd", "flash_bwd_dq",
           "flash_bwd_dkv", "flash_fwd_plain", "flash_bwd_plain",
           "philox4x32_10", "dropout_keep_mask", "dropout_threshold",
           "kernel_plan", "MAX_HEAD_DIM"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256                 # the JAX gate's d <= 256 (``supported``)


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
def _additive(bias, dtype):
    """A bool keep-mask as the additive ``where(mask, 0, -1e30)`` in
    ``dtype`` (``register.py`` ``_sdpa_pallas``); a float bias as it is."""
    if bias.dtype == torch.bool:
        return torch.where(bias, 0.0, _NEG_INF).to(dtype)
    return bias


def _norm_window(window):
    """``window`` as the kernels take it: None, or (left, right) with None
    for an open side; a negative side is open and ``(None, None)`` is no
    window (JAX ``flash_attention``)."""
    if window is None:
        return None
    left, right = (None if w is None or w < 0 else int(w) for w in window)
    return None if left is None and right is None else (left, right)


def _visible(Sq, Sk, causal, device, q_seg=None, kv_seg=None, fm=None,
             window=None):
    """The visibility mask of the kernels' rules: [Sq, Sk]; [B, 1, Sq, Sk]
    with segments, [B, Hm, Sq, Sk] with the flashmask rows."""
    qpos = torch.arange(Sq, device=device)[:, None]
    d = torch.arange(Sk, device=device)[None, :] - qpos - (Sk - Sq)
    ok = (d <= 0) if causal else torch.ones(Sq, Sk, dtype=torch.bool,
                                            device=device)
    window = _norm_window(window)
    if window is not None:
        left, right = window
        if left is not None:
            ok = ok & (d >= -left)
        if right is not None:
            ok = ok & (d <= right)
    if q_seg is not None:
        ok = ok & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    if fm is not None:
        start, end = (t[:, :, None, :] for t in fm)         # [B, Hm, 1, Sk]
        ok = ok & ~((start <= qpos) & (qpos < end))
    return ok


def _scores(q, k, causal, sm_scale, q_seg=None, kv_seg=None, bias=None,
            fm=None, window=None):
    """fp32 scores [B, H, Sq, Sk] with k's heads repeated over their group
    and the bias added in fp32, and the visibility mask (``_visible``)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * sm_scale
    if bias is not None:
        s = s + _additive(bias, q.dtype).float()
    return s, _visible(Sq, Sk, causal, q.device, q_seg, kv_seg, fm, window)


def flash_fwd_plain(q, k, v, causal: bool, sm_scale: float, bias=None,
                    q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                    seed: int = 0, fm=None, window=None):
    """Plain PyTorch forward: (out in q's dtype, lse fp32 [B, H, Sq]);
    ``bias`` (broadcast to [B, H, Sq, Sk]; a bool keep-mask as
    ``where(mask, 0, -1e30)`` in q's dtype) is added in fp32 to the scaled
    scores; ``q_seg`` / ``kv_seg`` (int [B, Sq] / [B, Sk]) mask pairs of
    different segments; ``fm`` = (start, end) (int [B, 1|H, Sk]) masks key
    j for queries start[j] <= i < end[j]; ``window`` = (left, right) keeps
    the band around the bottom-right aligned diagonal; ``dropout_p`` drops
    with ``dropout_keep_mask(seed, ...)``."""
    s, ok = _scores(q, k, causal, sm_scale, q_seg, kv_seg, bias, fm, window)
    B, Sq, H, _ = q.shape
    Hkv = k.shape[2]
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
               seed, bias=None, fm=None, window=None):
    """fp32 (p, p kept and rescaled, dP masked and rescaled) [B, H, Sq, Sk]
    from the saved lse, with k and v repeated over their query groups."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    s, ok = _scores(q, k, causal, sm_scale, q_seg, kv_seg, bias, fm, window)
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


def _plain_bwd(q, k, v, lse, do, causal, sm_scale, delta, q_seg, kv_seg,
               dropout_p, seed, bias, fm=None, window=None):
    """(dq, dk, dv, delta, dS without the scale fp32 [B, H, Sq, Sk])."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    p, p_kept, dp = _bwd_probs(q, k, v, lse, do, causal, sm_scale, q_seg,
                               kv_seg, dropout_p, seed, bias, fm, window)
    if delta is None:
        delta = (p * dp).sum(-1)
    ds_raw = p * (dp - delta[..., None])
    ds = ds_raw * sm_scale
    kf = k.float().repeat_interleave(g, dim=2)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kept, do.float())
    dk = dk.reshape(B, Sk, Hkv, g, D).sum(3)
    dv = dv.reshape(B, Sk, Hkv, g, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), delta, ds_raw


def _reduce_dbias(ds, bias):
    """The full-resolution d-bias [B, H, Sq, Sk] summed over the bias's
    broadcast dims and cast to its dtype (``_flash_bwd``)."""
    shape = (1,) * (4 - bias.dim()) + tuple(bias.shape)
    dims = [i for i in range(4) if shape[i] == 1 and ds.shape[i] != 1]
    if dims:
        ds = ds.sum(dims, keepdim=True)
    return ds.reshape(bias.shape).to(bias.dtype)


def _check_bias_grad(bias, bias_grad):
    if bias_grad and (bias is None or not bias.is_floating_point()):
        raise ValueError("bias_grad needs a float bias (the gradient of a "
                         "bool mask is not defined)")


def flash_bwd_plain(q, k, v, lse, do, causal: bool, sm_scale: float,
                    delta=None, q_seg=None, kv_seg=None,
                    dropout_p: float = 0.0, seed: int = 0, bias=None,
                    bias_grad: bool = False, fm=None, window=None):
    """Plain PyTorch backward from the saved lse: (dq, dk, dv) in the
    inputs' dtypes, with dk and dv summed over each kv head's query group,
    and with ``bias_grad`` the d-bias in the bias's shape and dtype. The
    bias, segments, flashmask rows, window and dropout as the forward took
    them: dV takes the kept,
    rescaled p; dP is masked and rescaled before dS = p (dP - delta) scale
    with the undropped p and delta = rowsum(p * dP) in fp32, as the kernels
    form it; ``delta`` ([B, H, Sq] fp32), when given, stands for it. The
    d-bias is dS without the scale, summed over the bias's broadcast dims."""
    _check_bias_grad(bias, bias_grad)
    dq, dk, dv, _, ds_raw = _plain_bwd(q, k, v, lse, do, causal, sm_scale,
                                       delta, q_seg, kv_seg, dropout_p, seed,
                                       bias, fm, window)
    if bias_grad:
        return dq, dk, dv, _reduce_dbias(ds_raw, bias)
    return dq, dk, dv


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
    (fp32, bf16 or fp16), a unit stride over D, 1 <= D <= MAX_HEAD_DIM, H a
    multiple of H_kv."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, S, H, D] tensors")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"H={H} is not a multiple of H_kv={k.shape[2]}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention kernels take 1 <= D <= "
                         f"{MAX_HEAD_DIM}, got {D}")
    for i, t in enumerate((q, k, v) + more):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"input {i} is {t.dtype} on {t.device}; q is "
                            f"{q.dtype} on {q.device}")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"input {i} needs a unit stride over D (strides "
                             f"{t.stride()})")


def _row_width(D, itemsize):
    """The head width the kernels read: D up to whole 16-byte words."""
    per = 16 // itemsize
    return -(-D // per) * per


def _broadcasts(t):
    """True for a view that repeats itself over a (batch, seq, head) dim
    longer than 1 (stride 0): the kernels read every input through TMA
    tensor maps, which take no zero stride."""
    return any(st == 0 and n > 1 for st, n in zip(t.stride()[:3],
                                                   t.shape[:3]))


def _padded(Dr, *ts):
    """The inputs as the kernels read them: a head narrower than ``Dr`` is
    copied once into a zero-padded contiguous buffer, and a broadcast view
    (``_broadcasts``) into a contiguous one; then every base and (batch,
    seq, head) stride must be 16-byte aligned."""
    out = []
    for i, t in enumerate(ts):
        if t.shape[-1] != Dr:
            t = torch.nn.functional.pad(t, (0, Dr - t.shape[-1]))
        elif _broadcasts(t):
            t = t.contiguous()
        it = t.element_size()
        if t.data_ptr() % 16 or any(s * it % 16 for s in t.stride()[:3]):
            raise ValueError(f"input {i}: base and strides must be 16-byte "
                             f"aligned (strides {t.stride()})")
        out.append(t)
    return out


def _cut(t, D):
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def _bias_view(bias, q, k):
    """(view, dtype code, strides): the bias as the kernels read it, a
    [B, H, Sq, Sk] view with stride 0 over its broadcast dims (``expand``
    copies nothing) in its own float dtype; a bool keep-mask becomes
    ``where(mask, 0, -1e30)`` in q's dtype, as ``_sdpa_pallas`` makes it.
    No bias: (None, 0, zero strides)."""
    if bias is None:
        return None, 0, (0, 0, 0, 0)
    B, Sq, H, _ = q.shape
    full = (B, H, Sq, k.shape[1])
    if bias.dim() > 4 or any(n not in (1, m) for n, m in
                             zip(bias.shape[::-1], full[::-1])):
        raise ValueError(f"bias must broadcast to {list(full)}, got "
                         f"{tuple(bias.shape)}")
    if bias.device != q.device:
        raise ValueError(f"bias is on {bias.device}, q on {q.device}")
    bias = _additive(bias, q.dtype)
    if bias.dtype not in _DTYPE_CODE:
        raise TypeError(f"the bias must be bool, float32, bfloat16 or "
                        f"float16, got {bias.dtype}")
    bias = bias.expand(full)
    return bias, _DTYPE_CODE[bias.dtype], bias.stride()


def _seg_view(seg, B, S, device, what):
    """Segment ids as the kernels read them: contiguous int32 [B, S] on
    q's device."""
    seg = torch.as_tensor(seg, device=device)
    if seg.shape != (B, S) or seg.is_floating_point():
        raise ValueError(f"{what} must be integer [{B}, {S}], got {seg.dtype} "
                         f"{tuple(seg.shape)}")
    return seg.to(torch.int32).contiguous()


def _fm_view(fm, q, k):
    """The flashmask rows as the kernels read them: (start, end) contiguous
    int32 [B, Hm, Sk] on q's device with Hm 1 or H, and the head stride
    (0 or Sk); None: (None, None), 0."""
    if fm is None:
        return (None, None), 0
    B, Sk, H = q.shape[0], k.shape[1], q.shape[2]
    start, end = fm
    rows = []
    for name, t in (("start", start), ("end", end)):
        t = torch.as_tensor(t, device=q.device)
        if (t.dim() != 3 or t.shape[0] != B or t.shape[1] not in (1, H)
                or t.shape[2] != Sk or t.is_floating_point()
                or t.dtype == torch.bool):
            raise ValueError(f"flashmask {name} rows must be integer "
                             f"[{B}, 1|{H}, {Sk}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        rows.append(t.to(torch.int32).contiguous())
    if rows[0].shape != rows[1].shape:
        raise ValueError(f"flashmask start {tuple(rows[0].shape)} and end "
                         f"{tuple(rows[1].shape)} differ")
    return tuple(rows), (Sk if rows[0].shape[1] > 1 else 0)


def _mask_args(q, k, fm, window):
    """The C entries' (fms, fme) pointers and (fm_hs, win_left, win_right),
    and the row views they point into (kept alive by the caller)."""
    rows, fm_hs = _fm_view(fm, q, k)
    window = _norm_window(window) or (None, None)
    ptrs = tuple(None if t is None else t.data_ptr() for t in rows)
    return rows, ptrs, (fm_hs, *(-1 if w is None else w for w in window))


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


def _tag(q, k, bias, q_seg, dropout_p, fm=None, window=None):
    B, Sq, H, D = q.shape
    window = _norm_window(window)
    extra = "".join((f", {bias.dtype} bias" if bias is not None else "",
                     ", segments" if q_seg is not None else "",
                     f", flashmask rows [{B}, {fm[0].shape[1]}, {k.shape[1]}]"
                     if fm is not None else "",
                     f", window {window}" if window is not None else "",
                     f", dropout {dropout_p}" if dropout_p else ""))
    return (f"(B={B} Sq={Sq} Sk={k.shape[1]} H={H} H_kv={k.shape[2]} D={D} "
            f"{q.dtype}{extra})")


_PLAN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_DESIGNS = ("wgmma+tma", "wgmma-3xtf32")


def kernel_plan(name: str, D: int, dtype, bias: bool = False) -> dict:
    """How the built library serves a call of ``name`` (``flash_fwd``,
    ``flash_bwd_dq`` or ``flash_bwd_dkv``) at head dim ``D`` in ``dtype``,
    with or without a bias: ``design`` ("wgmma+tma": the bf16 / fp16
    tensor-core kernels; "wgmma-3xtf32": the fp32 kernels on the TF32
    tensor cores, each operand split into two TF32 halves),
    ``query_rows`` and ``keys`` of its tiles, and ``key_major`` (a block
    owns a key tile and walks the queries). Read from the library's
    ``ptt_flash_plan``, which reports the constants its kernels were
    instantiated with; it builds the library on first use."""
    from ._build import load_library
    if name not in _PLAN_KERNELS or dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel_plan: no flash kernel {name} for {dtype}")
    out = (ctypes.c_int * 4)()
    dr = _row_width(D, torch.tensor([], dtype=dtype).element_size())
    code = load_library().ptt_flash_plan(_PLAN_KERNELS.index(name), dr,
                                         _DTYPE_CODE[dtype], int(bias), out)
    if code != 0:
        raise ValueError(f"kernel_plan: {name} takes no D={D} in {dtype}")
    return dict(design=_DESIGNS[out[0]], query_rows=out[1], keys=out[2],
                key_major=bool(out[3]))


def flash_fwd(q, k, v, causal: bool, sm_scale: float, bias=None, q_seg=None,
              kv_seg=None, dropout_p: float = 0.0, seed: int = 0, fm=None,
              window=None):
    """(out [B, Sq, H, D] in q's dtype, lse fp32 [B, H, Sq]); ``bias``: an
    additive float mask (or a bool keep-mask) that broadcasts to
    [B, H, Sq, Sk], read in its own dtype; ``q_seg`` / ``kv_seg``: integer
    segment ids [B, Sq] / [B, Sk]; ``fm``: the flashmask rows (start, end),
    integer [B, 1|H, Sk]; ``window``: (left, right); ``dropout_p`` with the
    64-bit ``seed``."""
    if is_cpu(q, "flash attention"):
        return flash_fwd_plain(q, k, v, causal, sm_scale, bias, q_seg, kv_seg,
                               dropout_p, seed, fm, window)
    _check_cuda(q, k, v)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dr = _row_width(D, q.element_size())
    q, k, v = _padded(Dr, q, k, v)
    segs, seg_ptrs, drop = _variant_args(q, k, q_seg, kv_seg, dropout_p, seed)
    rows, fm_ptrs, band = _mask_args(q, k, fm, window)
    bias, bias_code, bias_strides = _bias_view(bias, q, k)
    out = torch.empty(B, Sq, H, Dr, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    _launch(f"flash_fwd launch {_tag(q, k, bias, q_seg, dropout_p, fm, window)}",
            load_library().ptt_flash_fwd, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), *seg_ptrs, *fm_ptrs,
            out.data_ptr(), lse.data_ptr(),
            _strides(q, k, v, extra=bias_strides), B, Sq, Sk, H, Hkv, Dr,
            float(sm_scale), int(causal), *drop, _DTYPE_CODE[q.dtype],
            bias_code, *band)
    del segs, rows, bias
    flash_fwd.LAUNCHES += 1
    return _cut(out, D), lse


def flash_bwd_dq(q, k, v, lse, do, causal: bool, sm_scale: float,
                 q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                 seed: int = 0, bias=None, bias_grad: bool = False, fm=None,
                 window=None):
    """(dq [B, Sq, H, D] in q's dtype, delta = rowsum(p * dP) fp32
    [B, H, Sq]), and with ``bias_grad`` a third item: the full-resolution
    d-bias, dS without the scale, fp32 [B, H, Sq, Sk]."""
    _check_bias_grad(bias, bias_grad)
    if is_cpu(q, "flash attention"):
        dq, _, _, delta, ds_raw = _plain_bwd(
            q, k, v, lse, do, causal, sm_scale, None, q_seg, kv_seg,
            dropout_p, seed, bias, fm, window)
        return (dq, delta, ds_raw) if bias_grad else (dq, delta)
    _check_cuda(q, k, v, do)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dr = _row_width(D, q.element_size())
    q, k, v, do = _padded(Dr, q, k, v, do)
    segs, seg_ptrs, drop = _variant_args(q, k, q_seg, kv_seg, dropout_p, seed)
    rows, fm_ptrs, band = _mask_args(q, k, fm, window)
    bias, bias_code, bias_strides = _bias_view(bias, q, k)
    lse = lse.contiguous()
    dq = torch.empty(B, Sq, H, Dr, dtype=q.dtype, device=q.device)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    dbias = (torch.empty(B, H, Sq, Sk, dtype=torch.float32, device=q.device)
             if bias_grad else None)
    _launch(f"flash_bwd_dq launch "
            f"{_tag(q, k, bias, q_seg, dropout_p, fm, window)}",
            load_library().ptt_flash_bwd_dq, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if dbias is None else dbias.data_ptr(), *seg_ptrs, *fm_ptrs,
            _strides(q, k, v, do, extra=bias_strides), B, Sq, Sk, H, Hkv, Dr,
            float(sm_scale), int(causal), *drop, _DTYPE_CODE[q.dtype],
            bias_code, *band)
    del segs, rows, bias
    flash_bwd_dq.LAUNCHES += 1
    return (_cut(dq, D), delta) + ((dbias,) if bias_grad else ())


def flash_bwd_dkv(q, k, v, lse, delta, do, causal: bool, sm_scale: float,
                  q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                  seed: int = 0, bias=None, fm=None, window=None):
    """(dk, dv) [B, Sk, H_kv, D] in k's dtype, from the ``delta`` that
    ``flash_bwd_dq`` returned."""
    if is_cpu(q, "flash attention"):
        return _plain_bwd(q, k, v, lse, do, causal, sm_scale, delta, q_seg,
                          kv_seg, dropout_p, seed, bias, fm, window)[1:3]
    _check_cuda(q, k, v, do)
    from ._build import load_library
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dr = _row_width(D, q.element_size())
    q, k, v, do = _padded(Dr, q, k, v, do)
    segs, seg_ptrs, drop = _variant_args(q, k, q_seg, kv_seg, dropout_p, seed)
    rows, fm_ptrs, band = _mask_args(q, k, fm, window)
    bias, bias_code, bias_strides = _bias_view(bias, q, k)
    lse, delta = lse.contiguous(), delta.contiguous()
    dk = torch.empty(B, Sk, Hkv, Dr, dtype=k.dtype, device=k.device)
    dv = torch.empty(B, Sk, Hkv, Dr, dtype=v.dtype, device=v.device)
    _launch(f"flash_bwd_dkv launch "
            f"{_tag(q, k, bias, q_seg, dropout_p, fm, window)}",
            load_library().ptt_flash_bwd_dkv, q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if bias is None else bias.data_ptr(), *seg_ptrs, *fm_ptrs,
            _strides(q, k, v, do, extra=bias_strides), B, Sq, Sk, H, Hkv, Dr,
            float(sm_scale), int(causal), *drop, _DTYPE_CODE[q.dtype],
            bias_code, *band)
    del segs, rows, bias
    flash_bwd_dkv.LAUNCHES += 1
    return _cut(dk, D), _cut(dv, D)


def flash_bwd(q, k, v, lse, do, causal: bool, sm_scale: float,
              q_seg=None, kv_seg=None, dropout_p: float = 0.0, seed: int = 0,
              bias=None, bias_grad: bool = False, fm=None, window=None):
    """(dq, dk, dv), and with ``bias_grad`` the d-bias in the bias's shape
    and dtype: the dQ kernel (which also forms delta and the full d-bias),
    then the dK/dV kernel; on the CPU, the plain backward."""
    if is_cpu(q, "flash attention"):
        return flash_bwd_plain(q, k, v, lse, do, causal, sm_scale,
                               q_seg=q_seg, kv_seg=kv_seg,
                               dropout_p=dropout_p, seed=seed, bias=bias,
                               bias_grad=bias_grad, fm=fm, window=window)
    variant = dict(q_seg=q_seg, kv_seg=kv_seg, dropout_p=dropout_p, seed=seed,
                   bias=bias, fm=fm, window=window)
    dq, delta, *ds = flash_bwd_dq(q, k, v, lse, do, causal, sm_scale,
                                  bias_grad=bias_grad, **variant)
    dk, dv = flash_bwd_dkv(q, k, v, lse, delta, do, causal, sm_scale,
                           **variant)
    if bias_grad:
        return dq, dk, dv, _reduce_dbias(ds[0], bias)
    return dq, dk, dv


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.LAUNCHES = 0


# ---------------------------------------------------------------------------
# autograd + public API
# ---------------------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: the forward saves (q, k, v, lse), the
    bias, the segment ids and the flashmask rows, and keeps the window and
    the dropout seed; the backward runs the two backward kernels from them.
    q, k and v are saved as the caller's views (for the model, views of its
    kept ``qkv``). The bias gets a gradient only with ``bias_grad``;
    otherwise it is a constant. The rows never get one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, q_seg, kv_seg,
                dropout_p, seed, bias_grad, fm_start, fm_end, window):
        fm = None if fm_start is None else (fm_start, fm_end)
        out, lse = flash_fwd(q, k, v, causal, sm_scale, bias, q_seg, kv_seg,
                             dropout_p, seed, fm, window)
        ctx.save_for_backward(q, k, v, lse, bias, q_seg, kv_seg, fm_start,
                              fm_end)
        ctx.causal, ctx.sm_scale, ctx.window = causal, sm_scale, window
        ctx.dropout_p, ctx.seed, ctx.bias_grad = dropout_p, seed, bias_grad
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse, bias, q_seg, kv_seg, fm_start, fm_end = \
            ctx.saved_tensors
        want_db = ctx.bias_grad and ctx.needs_input_grad[3]
        # dO arrives contiguous from the model; a stray layout is copied once
        grads = flash_bwd(q, k, v, lse, do.contiguous(), ctx.causal,
                          ctx.sm_scale, q_seg=q_seg, kv_seg=kv_seg,
                          dropout_p=ctx.dropout_p, seed=ctx.seed, bias=bias,
                          bias_grad=want_db,
                          fm=None if fm_start is None else (fm_start, fm_end),
                          window=ctx.window)
        db = grads[3] if want_db else None
        return (grads[0], grads[1], grads[2], db) + (None,) * 10


def flash_attention(query, key, value, causal=False, sm_scale=None, *,
                    bias=None, q_segment_ids=None, kv_segment_ids=None,
                    startend_row_indices=None, window=None, dropout_p=0.0,
                    dropout_seed=None, bias_grad=False):
    """Fused attention. query [B, Sq, H, D]; key / value [B, Sk, H_kv, D]
    with H % H_kv == 0 (GQA indexed, never repeated) -> [B, Sq, H, D].
    Differentiable in query, key and value.

    ``bias``: an additive float mask that broadcasts to [B, H, Sq, Sk]
    (use 0 / -1e30 for a bool mask; a bool keep-mask is converted so), read
    in its own dtype; a constant, or with ``bias_grad=True`` differentiable
    (the d-bias is summed over its broadcast dims). ``q_segment_ids`` /
    ``kv_segment_ids``: integer [B, Sq] / [B, Sk] packed-varlen ids, both or
    neither. ``startend_row_indices``: the flashmask rows (start, end),
    integer [B, 1|H, Sk]: key column j is masked for queries start[j] <= i <
    end[j]; no gradient. ``window``: (left, right) ints or None, the sliding
    window around the bottom-right aligned diagonal (negative or None: that
    side open). ``dropout_p`` > 0 needs ``dropout_seed`` (an int; the
    forward and backward draw the same mask from it). The bias, segments,
    rows, window and dropout combine freely. On the card D is at most 256
    and the dtype fp32, bf16 or fp16."""
    _check_bias_grad(bias, bias_grad)
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
    q_seg = kv_seg = None
    if q_segment_ids is not None:
        q_seg = _seg_view(q_segment_ids, query.shape[0], query.shape[1],
                          query.device, "q_segment_ids")
        kv_seg = _seg_view(kv_segment_ids, key.shape[0], key.shape[1],
                           query.device, "kv_segment_ids")
    (fm_start, fm_end), _ = _fm_view(startend_row_indices, query, key)
    return _Flash.apply(query, key, value, bias, bool(causal), scale, q_seg,
                        kv_seg, dropout_p, seed, bool(bias_grad), fm_start,
                        fm_end, _norm_window(window))
