"""Time the flash kernels of two checkouts on one card, in turns.

    python3 -m paddle_tpu_torch.profiler.flash_ab --parent DIR [--child DIR]

``DIR`` is the root of a checkout (the directory that holds
``paddle_tpu_torch/``); ``--child`` defaults to this checkout. Each version
runs in its own process (the two packages share a name), in the order
parent, child, child, parent, and times the forward, dQ and dK/dV kernels
at seven calls: the GPT-1.3B flagship's (B 8, S 1024, H 16, D 128, causal,
bf16, q / k / v strided views of one head-major qkv), the eager Llama's (q
[8, 1024, 16, 128], k / v [8, 1024, 4, 128], causal, bf16), the packed
BERT-base call ([10, 512, 12, 64] bf16, the corpus' segment ids from
``chip_smoke.py``'s ``bert_batch``, dropout 0.1), the padded BERT-base call
([16, 512, 12, 64] bf16, ``bench_bert_base``'s bool mask as a bf16 bias
[16, 1, 512, 512], dropout 0.1), flashmask form (a) (the Llama call with
``chip_smoke.py`` phase 29's causal document rows), phase 29's cell (b)
(q [2, 4096, 16, 128], k / v 4 heads, causal, a window of 1024) and the
widest head
(B 8, S 1024, H 16, D 256, causal, bf16, as ``chip_smoke.py`` phase 25
times it). Each time is the median
of 30 CUDA-event timings with the L2 flushed before each launch, as
``chip_smoke.py`` ``cuda_ms`` takes them. Both checkouts build their kernels
at first use. Prints one line per run and a last JSON line with the card's
name and power limit, every run, and each kernel's mean over the two runs
of each checkout with the child's share of the parent's time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

_WORKER = r'''
import json, math, statistics, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.models import bert as TB
_build.load_library()
assert FA.__file__.startswith(sys.argv[1]), FA.__file__
dev = "cuda"
flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

def ms(fn, runs=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        flush.zero_()
        torch.cuda._sleep(10_000_000)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

def kernels(q, k, v, do, causal, **var):
    scale = 1.0 / math.sqrt(q.shape[-1])
    fwd = dict(var)
    _, lse = FA.flash_fwd(q, k, v, causal, scale, **fwd)
    _, delta = FA.flash_bwd_dq(q, k, v, lse, do, causal, scale, **var)
    return [ms(lambda: FA.flash_fwd(q, k, v, causal, scale, **fwd)),
            ms(lambda: FA.flash_bwd_dq(q, k, v, lse, do, causal, scale, **var)),
            ms(lambda: FA.flash_bwd_dkv(q, k, v, lse, delta, do, causal,
                                        scale, **var))]

gen = torch.Generator(device=dev)
gen.manual_seed(0)
qkv = torch.randn(8, 1024, 16, 3, 128, generator=gen, device=dev).to(
    torch.bfloat16)
do = torch.randn(8, 1024, 16, 128, generator=gen, device=dev).to(torch.bfloat16)
res = {"gpt_flagship": kernels(qkv[:, :, :, 0], qkv[:, :, :, 1],
                               qkv[:, :, :, 2], do, True)}
del qkv, do
S = 512
rng = np.random.RandomState(0)
lens = rng.randint(S // 8, S + 1, (16,))
_, seg, _, _, _ = TB.pack_sequences([rng.randint(0, 30522, (n,))
                                     for n in lens], S)
seg = torch.from_numpy(seg).to(dev)
q, k, v, do = (torch.randn(seg.shape[0], S, 12, 64, generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(4))
res["bert_packed"] = kernels(q, k, v, do, False, q_seg=seg, kv_seg=seg,
                             dropout_p=0.1, seed=1235)
del q, k, v, do
# bench_bert_base's padded batch: RandomState(0) lengths in U[S/8, S] over
# 16 sequences, the mask valid[:, None, None, :] & valid[:, None, :, None]
B = 16
lens = np.random.RandomState(0).randint(S // 8, S + 1, (B,))
valid = torch.from_numpy(np.arange(S)[None, :] < lens[:, None]).to(dev)
mask = valid[:, None, None, :] & valid[:, None, :, None]
bias = torch.where(mask, 0.0, -1e30).to(torch.bfloat16)
q, k, v, do = (torch.randn(B, S, 12, 64, generator=gen, device=dev).to(
    torch.bfloat16) for _ in range(4))
res["bert_padded"] = kernels(q, k, v, do, False, bias=bias, dropout_p=0.1,
                             seed=2401)
del q, k, v, do, bias, mask
q, do = (torch.randn(8, 1024, 16, 128, generator=gen, device=dev).to(
    torch.bfloat16) for _ in range(2))
k, v = (torch.randn(8, 1024, 4, 128, generator=gen, device=dev).to(
    torch.bfloat16) for _ in range(2))
res["llama_gqa"] = kernels(q, k, v, do, True)
# phase 29's cell (a): C = 1 causal document rows, lengths
# RandomState(0).randint(64, 513) packed into each row of 1024
rng = np.random.RandomState(0)
rows = np.zeros((8, 1, 1024), np.int32)
for b in range(8):
    pos = 0
    while pos < 1024:
        n = min(int(rng.randint(64, 513)), 1024 - pos)
        rows[b, 0, pos:pos + n] = pos + n
        pos += n
start = torch.from_numpy(rows).to(dev)
res["flashmask_doc"] = kernels(q, k, v, do, True,
                               fm=(start, torch.full_like(start, 1024)))
del q, k, v, do
# phase 29's cell (b): the causal sliding window of 1024 at [2, 4096]
q, do = (torch.randn(2, 4096, 16, 128, generator=gen, device=dev).to(
    torch.bfloat16) for _ in range(2))
k, v = (torch.randn(2, 4096, 4, 128, generator=gen, device=dev).to(
    torch.bfloat16) for _ in range(2))
res["window"] = kernels(q, k, v, do, True, window=(1024, None))
del q, k, v, do
# chip_smoke.py phase 25's widest timed head: D 256, B 8, S 1024, H 16
q, k, v, do = (torch.randn(8, 1024, 16, 256, generator=gen, device=dev).to(
    torch.bfloat16) for _ in range(4))
res["head_dim_256"] = kernels(q, k, v, do, True)
print(json.dumps(res))
'''


def _run(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", _WORKER, str(root)],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--child", type=Path,
                    default=Path(__file__).resolve().parents[2])
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for tag in ("parent", "child", "child", "parent"):
        res = _run(getattr(args, tag).resolve())
        runs.append((tag, res))
        print(f"{tag}: " + "; ".join(
            f"{call} forward / dQ / dK/dV " + " / ".join(f"{t:.4f}" for t in ts)
            + " ms" for call, ts in res.items()), flush=True)
    summary = {}
    for call in runs[0][1]:
        for i, kernel in enumerate(("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")):
            mean = {tag: sum(r[call][i] for t, r in runs if t == tag) / 2
                    for tag in ("parent", "child")}
            summary[f"{call} {kernel}"] = dict(
                mean, child_share=mean["child"] / mean["parent"])
            print(f"{call} {kernel}: parent {mean['parent']:.4f} ms, child "
                  f"{mean['child']:.4f} ms, child / parent "
                  f"{mean['child'] / mean['parent']:.3f}  [{card}]")
    print(json.dumps({"card": card, "runs": runs, "means": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
