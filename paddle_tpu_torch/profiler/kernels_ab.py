"""Time the paged attention, Adam, norm and RoPE kernels of two checkouts on
one card, in turns.

    python3 -m paddle_tpu_torch.profiler.kernels_ab --parent DIR [--child DIR]

``DIR`` is the root of a checkout (the directory that holds
``paddle_tpu_torch/``); ``--child`` defaults to this checkout. Each version
runs in its own process (the two packages share a name), in the order
parent, child, child, parent, and times at bf16 the kernels of
``chip_smoke.py``'s main shapes: the ragged and paged decode kernels on a
decode batch (8 rows, 16 heads of 128, pages of 32, kv lengths 100-640),
the ragged kernel on phase 3's mixed batch (4 rows, C 128) and on the decode
batch over int8 pools,
one Adam update of a [24, 2048, 8192] leaf (bf16 p, g and moments), the
LayerNorm forward and dx kernels on x [5120, 768], the RMSNorm forward and
its whole backward (dx and the fp32 dw, through the autograd Function:
whatever kernels and composed sums a checkout runs) on x [8192, 2048]
and the RoPE kernel on q [8, 1024, 16, 128].
Each time is the median of 30 CUDA-event timings with the L2 flushed before
each launch, as ``chip_smoke.py`` ``cuda_ms`` takes them. Both checkouts
build their kernels at first use. Prints one line per run and a last JSON
line with the card's name and power limit.
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
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_adam as FAD
from paddle_tpu_torch.kernels import layer_norm as LN
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.kernels import rms_norm as RN
from paddle_tpu_torch.kernels import rope as RP
_build.load_library()
assert LN.__file__.startswith(sys.argv[1]), LN.__file__
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

gen = torch.Generator(device=dev)
gen.manual_seed(0)
bf = torch.bfloat16
rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev)
                             * scale).to(bf)
res = {}
rng = np.random.RandomState(0)
lens = [100, 173, 256, 311, 400, 467, 555, 640]
NB, bs, nb, H, D = 200, 32, 20, 16, 128
tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:8 * nb]
                          .reshape(8, nb).astype(np.int32)).to(dev)
kv = torch.tensor(lens, dtype=torch.int32, device=dev)
k_pool, v_pool = rnd(H, NB, bs, D), rnd(H, NB, bs, D)
q = rnd(8, 1, H, D)
ones = torch.ones(8, dtype=torch.int32, device=dev)
res["ragged_decode"] = ms(lambda: RPA.ragged_paged_attention(
    q, k_pool, v_pool, tables, ones, kv, 1 / math.sqrt(D)))
# the same decode batch over int8 pools with per-page absmax scales
ks, vs = (x.float().abs().amax((2, 3)) for x in (k_pool, v_pool))
k8, v8 = (torch.round(x.float() / sc[..., None, None] * 127).to(torch.int8)
          for x, sc in ((k_pool, ks), (v_pool, vs)))
res["ragged_decode_int8"] = ms(lambda: RPA.ragged_paged_attention(
    q, k8, v8, tables, ones, kv, 1 / math.sqrt(D), k_scales=ks, v_scales=vs))
del k8, v8
res["paged_decode"] = ms(lambda: PA.paged_decode_attention(
    q[:, 0], k_pool, v_pool, tables, kv, 1 / math.sqrt(D)))
# chip_smoke.py phase 3's case (b): a mixed batch of 4 rows, C 128 (a full
# prefill chunk over 384 keys, a fresh 100-token prefill, a decode row over
# 517 keys, an empty row)
mixed_q, mixed_kv = [128, 100, 1, 0], [384, 100, 517, 0]
mt = np.zeros((4, nb), np.int32)
free = list(rng.permutation(np.arange(1, NB)))
for r in range(4):
    for j in range(-(-mixed_kv[r] // bs)):
        mt[r, j] = free.pop()
qm = rnd(4, 128, H, D)
mt, ql_m, kv_m = (torch.tensor(a, dtype=torch.int32, device=dev)
                  for a in (mt, mixed_q, mixed_kv))
res["ragged_mixed"] = ms(lambda: RPA.ragged_paged_attention(
    qm, k_pool, v_pool, mt, ql_m, kv_m, 1 / math.sqrt(D)))
p, g = rnd(24, 2048, 8192, scale=0.02), rnd(24, 2048, 8192, scale=1e-3)
slot = {"moment1": rnd(24, 2048, 8192, scale=1e-3),
        "moment2": rnd(24, 2048, 8192, scale=1e-3).square()}
res["fused_adam"] = ms(lambda: FAD.adam_update(
    p, g, slot, 1e-4, 1, None, beta1=0.9, beta2=0.999, epsilon=1e-8,
    decoupled=0.01), runs=10)
del p, g, slot
x, dy = rnd(5120, 768, scale=3.0), rnd(5120, 768)
w = torch.randn(768, generator=gen, device=dev)
y, mean, rstd = LN.layer_norm_fwd(x, w, w, 1e-12)
res["layer_norm_fwd"] = ms(lambda: LN.layer_norm_fwd(x, w, w, 1e-12))
res["layer_norm_bwd_dx"] = ms(lambda: LN.layer_norm_bwd_dx(x, w, mean, rstd,
                                                           dy))
x, dy = rnd(8192, 2048, scale=3.0), rnd(8192, 2048)
w = torch.randn(2048, generator=gen, device=dev)
res["rms_norm_fwd"] = ms(lambda: RN.rms_norm_fwd(x, w, 1e-5))
# the whole backward (dx and the fp32 dw) through the autograd Function,
# whatever kernels a checkout runs for it
xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
yr = RN.rms_norm(xr, wr, 1e-5)
res["rms_norm_bwd"] = ms(lambda: torch.autograd.grad(yr, (xr, wr), dy,
                                                     retain_graph=True))
x = rnd(8, 1024, 16, 128)
ang = torch.rand(1024, 64, generator=gen, device=dev)
res["rope"] = ms(lambda: RP.rope(x, ang.cos(), ang.sin()))
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
        print(f"{tag}: " + "; ".join(f"{k} {t:.4f}" for k, t in res.items())
              + " ms", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
