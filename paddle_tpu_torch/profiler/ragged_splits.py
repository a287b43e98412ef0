"""Time the ragged paged-attention kernel at forced split counts, on the card.

    python3 -m paddle_tpu_torch.profiler.ragged_splits

The wgmma routes of ``kernels/ragged_paged_attention.py`` ("wgmma+tma" and,
for fp32, "wgmma-3xtf32") can cut each row's key tiles into contiguous
ranges over several blocks and merge them with a second kernel;
``kernel_plan`` picks the count from the shapes
(``csrc/ragged_paged_attention_hopper.cu`` and
``ragged_paged_attention_tf32_hopper.cu`` ``auto_splits``). This times
decode batches from one long row to the serving batch (16 query heads of
128, pages of 32, bf16 pools, the serving batch over int8 and fp8 pools,
and one row and the serving batch in fp32) and phase 3's mixed batch (in
bf16 and fp32) at split counts 1-16, each call checked
against the plain version first, and prints one line a case: its blocks
(rows x kv heads x query tiles), the plan's count and each count's time.
Each time is the median of 30 CUDA-event timings with the L2 flushed
before each launch, as ``chip_smoke.py`` ``cuda_ms`` takes them. The last
line is JSON with the card's name and power limit and every reading.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess

import numpy as np
import torch

from ..kernels import ragged_paged_attention as RPA

SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)
# rows, kv_len of each row, kv heads, pool dtype (None: bf16; float32: fp32
# queries and pools), C
CASES = (
    ("one row", [1], [8192], 16, None, 1),
    ("one row, GQA 16/4", [1], [8192], 4, None, 1),
    ("two rows", [1, 1], [8192, 8192], 16, None, 1),
    ("four rows", [1] * 4, [4096] * 4, 16, None, 1),
    ("eight rows, GQA 16/4", [1] * 8, [4096] * 8, 4, None, 1),
    ("serving decode", [1] * 8, [100, 173, 256, 311, 400, 467, 555, 640], 16,
     None, 1),
    ("serving decode, int8", [1] * 8, [100, 173, 256, 311, 400, 467, 555,
                                       640], 16, torch.int8, 1),
    ("serving decode, fp8", [1] * 8, [100, 173, 256, 311, 400, 467, 555,
                                      640], 16, torch.float8_e4m3fn, 1),
    ("sixteen rows", [1] * 16, [1024] * 16, 16, None, 1),
    ("mixed, C 128", [128, 100, 1, 0], [384, 100, 517, 0], 16, None, 128),
    ("one row, fp32", [1], [8192], 16, torch.float32, 1),
    ("serving decode, fp32", [1] * 8, [100, 173, 256, 311, 400, 467, 555,
                                       640], 16, torch.float32, 1),
    ("mixed, C 128, fp32", [128, 100, 1, 0], [384, 100, 517, 0], 16,
     torch.float32, 128),
)


def _ms(fn, flush, runs=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _case(rng, q_lens, kv_lens, hkv, pool, C, dev, hq=16, D=128, bs=32):
    R = len(q_lens)
    nb = max(-(-max(kv_lens) // bs), 1)
    NB = R * nb + 1
    tables = rng.permutation(np.arange(1, NB))[:R * nb].reshape(R, nb)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    bf = torch.bfloat16
    k, v = (t(rng.randn(hkv, NB, bs, D).astype(np.float32), torch.float32)
            for _ in range(2))
    extra = {}
    qdt = torch.float32 if pool == torch.float32 else bf
    if pool is None:
        k, v = k.to(bf), v.to(bf)
    elif pool != torch.float32:
        qmax = 127.0 if pool == torch.int8 else 448.0
        ks, vs = (x.abs().amax((2, 3)) for x in (k, v))
        k, v = (x / sc[..., None, None] * qmax
                for x, sc in ((k, ks), (v, vs)))
        if pool == torch.int8:
            k, v = k.round(), v.round()
        k, v = k.to(pool), v.to(pool)
        extra = dict(k_scales=ks, v_scales=vs)
    args = (t(rng.randn(R, C, hq, D).astype(np.float32), qdt), k, v,
            t(tables.astype(np.int32), torch.int32),
            t(np.asarray(q_lens, np.int32), torch.int32),
            t(np.asarray(kv_lens, np.int32), torch.int32), 1 / math.sqrt(D))
    return args, extra


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ragged_splits: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(0)
    res = {}
    for name, q_lens, kv_lens, hkv, pool, C in CASES:
        args, extra = _case(rng, q_lens, kv_lens, hkv, pool, C, dev)
        plan = RPA.kernel_plan(args[0], args[1], args[3])
        ref = RPA.ragged_paged_attention_plain(*args, **extra).float()
        times = {}
        for sp in sorted(set(SPLITS) | {plan["splits"]}):
            out = RPA.ragged_paged_attention(*args, splits=sp, **extra)
            err = (out.float() - ref).norm() / ref.norm()
            if not err <= 1e-2:
                raise RuntimeError(f"{name}: splits {sp} rel l2 {err}")
            times[sp] = _ms(lambda: RPA.ragged_paged_attention(
                *args, splits=sp, **extra), flush)
        blocks = len(q_lens) * hkv * -(-C * (16 // hkv) // plan["query_rows"])
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
