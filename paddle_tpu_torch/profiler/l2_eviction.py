"""Time short kernels after two kinds of L2 eviction, on the card.

    python3 -m paddle_tpu_torch.profiler.l2_eviction

``chip_smoke.py`` ``cuda_ms`` evicts the 50 MB L2 before each timed launch
with a 256 MB write, which leaves the L2 full of dirty lines that the timed
kernel must write back as it reads. This times the same calls after that
write and after a 256 MB read (clean lines), to show how much of a short
kernel's time the harness adds: the paged decode and the ragged kernel on
the serving decode batch (8 rows, 16 heads of 128, pages of 32, kv lengths
100-640, bf16) and SDPA over its pre-gathered pages; the RMSNorm backward
(dx and dw in one launch), its dx-only kernels and autograd of
``F.rms_norm`` on x [8192, 2048] bf16 with an fp32 weight; and a 4-byte
fill, the floor of a launch timed this way. Each time is the median of 30
CUDA-event timings. The last line is JSON with the card's name and power
limit and every reading.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from ..kernels import paged_attention as PA
from ..kernels import ragged_paged_attention as RPA
from ..kernels import rms_norm as RN
from .paged_splits import _case


def _ms(fn, evict, runs=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        evict()
        torch.cuda._sleep(10_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _calls(dev):
    F = torch.nn.functional
    q, kp, vp, tables, lens, scale = args = _case(
        np.random.RandomState(0), [100, 173, 256, 311, 400, 467, 555, 640],
        16, 16, dev)
    rargs = (q.contiguous()[:, None], kp, vp, tables, torch.ones_like(lens),
             lens, scale)
    hkv, _, bs, D = kp.shape
    B, nb = tables.shape
    k, v = (p[:, tables.long()].reshape(hkv, B, nb * bs, D).transpose(0, 1)
            .contiguous() for p in (kp, vp))
    mask = (torch.arange(nb * bs, device=dev)[None]
            < lens.long()[:, None])[:, None, None]
    qt = q.contiguous()[:, :, None]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x, dy = (torch.randn(8192, 2048, generator=gen, device=dev)
             .to(torch.bfloat16) for _ in range(2))
    w = torch.randn(2048, generator=gen, device=dev)
    _, rstd = RN.rms_norm_fwd(x, w, 1e-5)
    xl, wl = x.clone().requires_grad_(True), \
        w.to(torch.bfloat16).requires_grad_(True)
    yl = F.rms_norm(xl, (2048,), wl, 1e-5)
    tiny = torch.empty(1, device=dev)
    return {
        "paged decode": lambda: PA.paged_decode_attention(*args),
        "ragged, same batch": lambda: RPA.ragged_paged_attention(*rargs),
        "SDPA, pre-gathered pages": lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask, scale=scale),
        "RMSNorm backward": lambda: RN.rms_norm_bwd(x, w, rstd, dy),
        "RMSNorm backward, dx only": lambda: RN.rms_norm_bwd(
            x, w, rstd, dy, need_dw=False),
        "autograd of F.rms_norm": lambda: torch.autograd.grad(
            yl, (xl, wl), dy, retain_graph=True),
        "4-byte fill": tiny.zero_,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("l2_eviction: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    res = {}
    for name, fn in _calls(dev).items():
        res[name] = dict(after_write=_ms(fn, flush.zero_),
                         after_read=_ms(fn, flush.sum))
        print(f"{name}: after a 256 MB write {res[name]['after_write']:.4f}"
              f" ms, after a 256 MB read {res[name]['after_read']:.4f} ms"
              f"  [{card}]", flush=True)
    print(json.dumps({"card": card, "ms": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
