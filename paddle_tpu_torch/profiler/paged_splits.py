"""Time the paged decode kernel at forced split counts, on the card.

    python3 -m paddle_tpu_torch.profiler.paged_splits

The "bulk-ring" route of ``kernels/paged_attention.py`` can cut each row's
pages into contiguous ranges over several blocks, the last of them to
finish merging the others; ``kernel_plan`` picks the count from the shapes
(``csrc/paged_decode_hopper.cu`` ``auto_splits``). This times the serving
decode batch (8 rows, 16 heads of 128, pages of 32, kv lengths 100-640,
bf16) and one and two rows of 8192 keys under GQA 16/4 at split counts
1-16, each call checked against the plain version first, and prints one
line a case: its blocks ((row, kv head) pairs x chunks of the group), the
plan's count and each count's time. Each time is the median of 30
CUDA-event timings with the L2 flushed before each launch, as
``chip_smoke.py`` ``cuda_ms`` takes them. The last line is JSON with the
card's name and power limit and every reading.
"""

from __future__ import annotations

import json
import math
import subprocess

import numpy as np
import torch

from ..kernels import paged_attention as PA
from .ragged_splits import _ms

SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
# kv_len of each row, query heads, kv heads
CASES = (
    ("serving decode", [100, 173, 256, 311, 400, 467, 555, 640], 16, 16),
    ("one row of 8192 keys, GQA 16/4", [8192], 16, 4),
    ("two rows of 8192 keys, GQA 16/4", [8192] * 2, 16, 4),
)


def _case(rng, lens, hq, hkv, dev, D=128, bs=32):
    """q a strided view of a head-major qkv, as the decode burst gives it;
    pages in random table order."""
    B = len(lens)
    nb = max(-(-max(lens) // bs), 1)
    NB = B * nb + 1
    tables = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)
    t = lambda a, dt=torch.bfloat16: torch.from_numpy(
        np.ascontiguousarray(a)).to(dev, dt)
    qkv = t(rng.randn(B, hq, 3, D).astype(np.float32))
    return (qkv[:, :, 0], t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(tables.astype(np.int32), torch.int32),
            t(np.asarray(lens, np.int32), torch.int32), 1 / math.sqrt(D))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("paged_splits: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)
    res = {}
    for name, lens, hq, hkv in CASES:
        args = _case(rng, lens, hq, hkv, dev)
        plan = PA.kernel_plan(args[0], args[1], args[3], args[2])
        ref = PA.paged_decode_attention_plain(*args).float()
        times = {}
        for sp in sorted(set(SPLITS) | {plan["splits"]}):
            out = PA.paged_decode_attention(*args, splits=sp)
            err = (out.float() - ref).norm() / ref.norm()
            if not err <= 1e-2:
                raise RuntimeError(f"{name}: splits {sp} rel l2 {err}")
            times[sp] = _ms(lambda: PA.paged_decode_attention(
                *args, splits=sp), flush)
        blocks = len(lens) * hkv * -(-(hq // hkv) // plan["rows"])
        res[name] = dict(blocks=blocks, plan=plan["splits"], ms=times)
        best = min(times, key=times.get)
        print(f"{name} ({blocks} blocks): plan {plan['splits']} splits "
              f"{times[plan['splits']]:.4f} ms; best {best} "
              f"{times[best]:.4f}; " + " ".join(
                  f"{sp}:{t:.4f}" for sp, t in times.items())
              + f"  [{card}]", flush=True)
    print(json.dumps({"card": card, "cases": res}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
