"""One-pass Adam/AdamW leaf update (counterpart:
``paddle_tpu/kernels/pallas/fused_adam.py`` ``supported`` and
``adam_update``, kernel body ``_kernel``).

The TPU kernel is replaced by a CUDA kernel written by hand for Hopper,
``paddle_tpu_torch/csrc/fused_adam.cu``. Its source note states the design; in
short: bandwidth-bound (14 bytes per element for bf16 p, g and moments
against 3.35 TB/s), one coalesced pass that reads and writes each element
once, fp32 math in registers, and a counter-based Philox draw for the
stochastic rounding of a bf16 moment2, seeded per leaf by the caller.

Each of p, g, moment1 and moment2 is fp32, bf16 or fp16, in its own dtype,
as the JAX gate admits them; the master, when present, is fp32.

``adam_update`` is the wrapper. It updates ``p`` and the slot's tensors IN
PLACE (the Pallas kernel aliases the same buffers through
``input_output_aliases``) and returns ``(p, slot)``. A CUDA tensor goes to the
kernel, or the call raises; a CPU tensor goes to ``adam_update_plain``, the
same math in plain PyTorch with the rounding noise as an explicit tensor.
``adam_update.LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["supported", "adam_update", "adam_update_plain", "sr_noise",
           "shard_window", "bias_corrections"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def supported(p, g, slot) -> bool:
    """The JAX package's eligibility rule for one dense leaf, unchanged: at
    least 65536 elements, ndim >= 2, matching shapes, moments present, an
    fp32 master if any, every array floating. Small leaves (biases, LayerNorm
    affine) take the composed update. It decides by shape and dtype, never
    on a failure."""
    if g is None or not hasattr(g, "dtype"):
        return False
    if p.numel() < (1 << 16) or p.dim() < 2:
        return False
    if p.shape != g.shape:
        return False
    for k in ("moment1", "moment2"):
        if k not in slot or slot[k].shape != p.shape:
            return False
    master = slot.get("master")
    if master is not None and (master.shape != p.shape
                               or master.dtype != torch.float32):
        return False
    return all(a.dtype.is_floating_point
               for a in (p, g, slot["moment1"], slot["moment2"]))


def bias_corrections(beta1: float, beta2: float, step: int):
    """(1 - beta1**step, 1 - beta2**step) in float32, as the JAX package
    computes them (``fused_adam.py:113-118``, ``optimizer.py:425-427``)."""
    s = np.float32(step)
    return (float(np.float32(1) - np.float32(beta1) ** s),
            float(np.float32(1) - np.float32(beta2) ** s))


def shard_window(seed, dim: int, start: int, full: int):
    """The rounding seed of a shard: the block ``[start, start + shape[dim])``
    of ``dim`` of a leaf whose ``dim`` is ``full`` long. Its elements draw
    the noise they draw in the whole leaf's update (None stays None)."""
    if seed is None:
        return None
    return (seed[0], seed[1], (int(dim), int(start), int(full)))


def _window(shape, seed):
    """(dim, start, full) of a shard's seed, or None for a whole leaf."""
    if len(seed) < 3 or seed[2] is None:
        return None
    dim, start, full = seed[2]
    return (dim, start, full) if shape[dim] != full else None


def sr_noise(shape, seed, device) -> torch.Tensor:
    """Rounding noise for the plain version: uint32-valued (held in int64)
    draws from a ``torch.Generator`` seeded by the per-leaf seed. Only the low
    16 bits are used. A shard's seed (``shard_window``) draws the whole
    leaf's noise and keeps the shard's block."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed[0]) << 32) | int(seed[1]))
    shape = tuple(shape)
    win = _window(shape, seed)
    full = shape if win is None else \
        shape[:win[0]] + (win[2],) + shape[win[0] + 1:]
    noise = torch.randint(0, 1 << 32, full, generator=gen, device=device,
                          dtype=torch.int64)
    if win is not None:
        noise = noise.narrow(win[0], win[1], shape[win[0]])
    return noise


def sr_to_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Unbiased stochastic rounding f32 -> bf16 (counterpart:
    ``optimizer._sr_to_bf16``): add ``noise & 0xFFFF`` below the bf16 cut in
    integer space, then truncate. ``noise`` holds uint32 values (any integer
    dtype; int64 keeps them non-negative), so a test can feed JAX's own
    ``jax.random.bits``. The sum is taken in int64, so nothing wraps."""
    bits = x.float().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + (noise.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    return (rounded >> 16).to(torch.int32).to(torch.int16).view(
        torch.bfloat16)


def adam_update_plain(p, g, slot, lr, step, noise=None, *, beta1, beta2,
                      epsilon, l2=0.0, decoupled=0.0):
    """Plain PyTorch version of the kernel, in place, with the kernel's
    order of operations. ``noise`` (uint32 values, ``p``'s shape) turns on
    the stochastic rounding of a bf16 moment2; None rounds to nearest."""
    # the bias corrections as 0-dim tensors on the leaf's device, not Python
    # floats: CUDA divides by a host scalar as a multiply by its reciprocal,
    # one fp32 ulp away from the kernel's (and the Pallas kernel's) division
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=p.device)
              for c in bias_corrections(beta1, beta2, step))
    m1s, m2s = slot["moment1"], slot["moment2"]
    master = slot.get("master")
    pf = master if master is not None else p.float()
    gf = g.float()
    if l2:
        gf = gf + float(np.float32(l2)) * pf
    m1 = beta1 * m1s.float() + (1.0 - beta1) * gf
    m2 = beta2 * m2s.float() + (1.0 - beta2) * gf * gf
    upd = (m1 / c1) / (torch.sqrt(m2 / c2) + epsilon)
    new_pf = pf - lr * upd
    if decoupled:
        new_pf = new_pf - float(np.float32(lr) * np.float32(decoupled)) * pf
    p.copy_(new_pf)
    m1s.copy_(m1)
    if noise is not None and m2s.dtype == torch.bfloat16:
        m2s.copy_(sr_to_bf16(m2, noise))
    else:
        m2s.copy_(m2)
    if master is not None:
        master.copy_(new_pf)
    return p, slot


def _check_cuda(p, g, slot):
    """The kernel's operands: on p's device, contiguous, p's shape, each of
    p, g, moment1 and moment2 in its own float dtype (fp32, bf16 or fp16),
    the master fp32."""
    m1, m2 = slot["moment1"], slot["moment2"]
    master = slot.get("master")
    named = [("p", p), ("g", g), ("moment1", m1), ("moment2", m2)]
    if master is not None:
        named.append(("master", master))
    for name, t in named:
        if t.device != p.device:
            raise ValueError(f"fused_adam: {name} is on {t.device}, p on "
                             f"{p.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} must be contiguous")
        if t.shape != p.shape:
            raise ValueError(f"fused_adam: {name} shape {tuple(t.shape)} != "
                             f"p shape {tuple(p.shape)}")
    for name, t in named[:4]:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"fused_adam kernel takes float32, bfloat16 or "
                            f"float16 arrays, got {name} {t.dtype}")
    if master is not None and master.dtype != torch.float32:
        raise TypeError(f"fused_adam: master must be float32, got "
                        f"{master.dtype}")


def adam_update(p: torch.Tensor, g: torch.Tensor, slot: Dict[str, torch.Tensor],
                lr: float, step: int, seed: Optional[Tuple[int, int]], *,
                beta1: float, beta2: float, epsilon: float, l2: float = 0.0,
                decoupled: float = 0.0):
    """One fused update of one leaf, in place; returns ``(p, slot)``.
    ``l2`` folds decay into the gradient (Adam), ``decoupled`` applies
    AdamW's decay. ``seed`` (two 32-bit ints, None = off) turns on the
    stochastic rounding of a bf16 moment2; a shard's seed (``shard_window``)
    draws the whole leaf's noise at the shard's elements. ``step`` is the
    1-based step the bias corrections use.

    CPU tensors take the plain version (noise from ``sr_noise(seed)``); CUDA
    tensors launch the kernel or raise: TypeError or ValueError for a dtype,
    device or layout the kernel does not take, RuntimeError for a failed
    launch."""
    sr = seed is not None and slot["moment2"].dtype == torch.bfloat16
    if p.device.type == "cpu":
        noise = sr_noise(p.shape, seed, p.device) if sr else None
        return adam_update_plain(p, g, slot, lr, step, noise, beta1=beta1,
                                 beta2=beta2, epsilon=epsilon, l2=l2,
                                 decoupled=decoupled)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam: unsupported device {p.device}")
    _check_cuda(p, g, slot)
    from ._build import check, load_library
    lib = load_library()
    c1, c2 = bias_corrections(beta1, beta2, step)
    master = slot.get("master")
    k0, k1 = (int(seed[0]) & 0xFFFFFFFF, int(seed[1]) & 0xFFFFFFFF) if sr \
        else (0, 0)
    win = _window(tuple(p.shape), seed) if sr else None
    if win is None:
        window = (1, 1, 1, 0)
    else:
        dim, start, full = win
        window = (math.prod(p.shape[dim + 1:]), p.shape[dim], full, start)
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = lib.ptt_fused_adam(
            p.data_ptr(), g.data_ptr(), slot["moment1"].data_ptr(),
            slot["moment2"].data_ptr(),
            master.data_ptr() if master is not None else None, p.numel(),
            *(_DTYPE_CODE[t.dtype] for t in (p, g, slot["moment1"],
                                             slot["moment2"])),
            lr, c1, c2, beta1, 1.0 - beta1, beta2, 1.0 - beta2, epsilon,
            l2, decoupled, int(sr), k0, k1, *window, stream)
    check(code, f"fused_adam launch (n={p.numel()} p {p.dtype} g {g.dtype} "
          f"moments {slot['moment1'].dtype} {slot['moment2'].dtype} sr={sr})")
    adam_update.LAUNCHES += 1
    return p, slot


adam_update.LAUNCHES = 0
