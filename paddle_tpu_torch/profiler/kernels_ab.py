"""Time the paged attention, flash, Adam, norm and RoPE kernels of two
checkouts on one card, in turns.

    python3 -m paddle_tpu_torch.profiler.kernels_ab --parent DIR [--child DIR]
        [--only PREFIX[,PREFIX...]]

``DIR`` is the root of a checkout (the directory that holds
``paddle_tpu_torch/``); ``--child`` defaults to this checkout. Each version
runs in its own process (the two packages share a name), in the order
parent, child, child, parent, and times at bf16 the kernels of
``chip_smoke.py``'s main shapes: the ragged and paged decode kernels on a
decode batch (8 rows, 16 heads of 128, pages of 32, kv lengths 100-640),
the paged decode kernel on that batch in fp32 too, the ragged kernel on
phase 3's mixed batch (4 rows, C 128), on the decode batch over int8
pools, on both batches with fp32 queries and pools (phase 3's fp32 (a) and
(b)), on both batches at D 256 in bf16 and on the decode batch at D 256
over int8 and fp8 pools, on the decode batch over fp8 pools, with fp32
queries over int8 and fp8 pools, with pages of 12 keys in bf16, fp32
and bf16 over int8 pools, and with fp32 queries at D 64 (the decode batch
over fp32 and int8 pools, the mixed batch), and the fp32 calls past D_pad
128 (fp32 queries at D 160 on the decode batch, at D 256 on the decode and
mixed batches over fp32 pools and on the decode batch over int8 and fp8
pools), the flash dK/dV kernel at
phase 25's call (B 8, S 1024, H 16, causal) at D 256 and D 160 in bf16 and
D 256 in fp16, the fp32 flash forward, dQ and dK/dV at phase 6 (a)'s call
(B 8, S 1024, H 16, D 128, causal) and at D 160 and 256
there,
one Adam update of a [24, 2048, 8192] leaf (bf16 p, g and moments; with
the stochastic rounding off and on), the
LayerNorm forward on x [5120, 768] and [8192, 2048] in bf16, fp16 and fp32
(fp32 weight and bias) and its whole backward (dx, dw and db
through the autograd Function, fp32 weight and bias: whatever kernels and
composed sums a checkout runs) on x [5120, 768] and [41472, 768] (the
packed BERT cell's rows at 16 and 128 sequences), the RMSNorm forward and
its whole backward (dx and the fp32 dw, the same way) on x [8192, 2048],
the forward and the dx-only backward (a frozen weight's) there also in
fp16 beside bf16, and the RoPE kernel on q [8, 1024, 16, 128].
Each time is the median of 30 CUDA-event timings with the L2 flushed before
each launch, as ``chip_smoke.py`` ``cuda_ms`` takes them. Both checkouts
build their kernels at first use. Prints one line per run and a last JSON
line with the card's name and power limit. ``--only`` times the calls whose
result names start with one of its comma-separated prefixes and skips the
rest (their inputs are made all the same): ``ragged_`` the ragged kernel's
calls; ``ragged_decode_fp32,ragged_mixed_fp32,flash_fwd_fp32,flash_dq_fp32,
flash_dkv_fp32`` (one argument) the fp32 calls on the TF32 kernels.
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
from paddle_tpu_torch.kernels import flash_attention as FA
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
only = tuple(p for p in sys.argv[2].split(",") if p)   # --only's prefixes
rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device=dev)
                             * scale).to(bf)
res = {}


def want(*names):
    """Whether one of ``names`` is to be timed (``--only``)."""
    return not only or any(n.startswith(p) for n in names for p in only)


def time_as(name, fn, runs=30):
    if want(name):
        res[name] = ms(fn, runs)


rng = np.random.RandomState(0)
lens = [100, 173, 256, 311, 400, 467, 555, 640]
NB, bs, nb, H, D = 200, 32, 20, 16, 128
tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:8 * nb]
                          .reshape(8, nb).astype(np.int32)).to(dev)
kv = torch.tensor(lens, dtype=torch.int32, device=dev)
k_pool, v_pool = rnd(H, NB, bs, D), rnd(H, NB, bs, D)
q = rnd(8, 1, H, D)
ones = torch.ones(8, dtype=torch.int32, device=dev)


def mixed_batch(rng):
    """chip_smoke.py phase 3's case (b) tables: a mixed batch of 4 rows, C
    128 (a full prefill chunk over 384 keys, a fresh 100-token prefill, a
    decode row over 517 keys, an empty row)."""
    mixed_q, mixed_kv = [128, 100, 1, 0], [384, 100, 517, 0]
    mt = np.zeros((4, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for r in range(4):
        for j in range(-(-mixed_kv[r] // bs)):
            mt[r, j] = free.pop()
    return (torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (mt, mixed_q, mixed_kv))


def quantized(x, pool):
    """x [H, NB, bs, D] as int8 / fp8 e4m3 pools, with its per-page absmax
    scales."""
    qmax = 127.0 if pool == torch.int8 else 448.0
    sc = x.float().abs().amax((2, 3))
    xq = x.float() / sc[..., None, None] * qmax
    if pool == torch.int8:
        xq = torch.round(xq)
    return xq.clamp(-qmax, qmax).to(pool), sc


def tf32_ragged():
    """fp32 queries on the TF32 ragged kernel past D_pad 128: the decode
    batch at D 160 and 256, the mixed batch and int8 / fp8 pools at 256."""
    for Dh in (160, 256):
        qd, kd, vd = (torch.randn(*s, generator=gen, device=dev) for s in (
            (8, 1, H, Dh), (H, NB, bs, Dh), (H, NB, bs, Dh)))
        sc = 1 / math.sqrt(Dh)
        time_as(f"ragged_decode_fp32_d{Dh}", lambda: RPA.ragged_paged_attention(
            qd, kd, vd, tables, ones, kv, sc))
        if Dh == 256:
            qmd = torch.randn(4, 128, H, Dh, generator=gen, device=dev)
            time_as(f"ragged_mixed_fp32_d{Dh}", lambda: RPA.ragged_paged_attention(
                qmd, kd, vd, mt, ql_m, kv_m, sc))
            del qmd
            for pool, ptag in ((torch.int8, "int8"),
                               (torch.float8_e4m3fn, "fp8")):
                (kq, ks), (vq, vs) = quantized(kd, pool), quantized(vd, pool)
                time_as(f"ragged_decode_fp32_{ptag}_d{Dh}",
                        lambda: RPA.ragged_paged_attention(
                            qd, kq, vq, tables, ones, kv, sc, k_scales=ks,
                            v_scales=vs))
                del kq, vq
        del qd, kd, vd
    torch.cuda.empty_cache()


def tf32_flash():
    """The fp32 flash forward, dQ and dK/dV at the GPT call (B 8, S 1024,
    H 16, causal) at D 160 and 256."""
    for Dh in (160, 256):
        qf, kf, vf, dof = (torch.randn(8, 1024, 16, Dh, generator=gen,
                                       device=dev) for _ in range(4))
        sc = 1 / math.sqrt(Dh)
        time_as(f"flash_fwd_fp32_d{Dh}", lambda: FA.flash_fwd(
            qf, kf, vf, True, sc))
        if want(f"flash_dq_fp32_d{Dh}", f"flash_dkv_fp32_d{Dh}"):
            _, lse = FA.flash_fwd(qf, kf, vf, True, sc)
            _, delta = FA.flash_bwd_dq(qf, kf, vf, lse, dof, True, sc)
            time_as(f"flash_dq_fp32_d{Dh}", lambda: FA.flash_bwd_dq(
                qf, kf, vf, lse, dof, True, sc))
            time_as(f"flash_dkv_fp32_d{Dh}", lambda: FA.flash_bwd_dkv(
                qf, kf, vf, lse, delta, dof, True, sc))
            del lse, delta
        del qf, kf, vf, dof
    torch.cuda.empty_cache()


time_as("ragged_decode", lambda: RPA.ragged_paged_attention(
    q, k_pool, v_pool, tables, ones, kv, 1 / math.sqrt(D)))
# the same decode batch over int8 pools with per-page absmax scales
ks, vs = (x.float().abs().amax((2, 3)) for x in (k_pool, v_pool))
k8, v8 = (torch.round(x.float() / sc[..., None, None] * 127).to(torch.int8)
          for x, sc in ((k_pool, ks), (v_pool, vs)))
time_as("ragged_decode_int8", lambda: RPA.ragged_paged_attention(
    q, k8, v8, tables, ones, kv, 1 / math.sqrt(D), k_scales=ks, v_scales=vs))
# fp32 queries over the int8 pools, and both over fp8 e4m3 pools
q32 = q.float()
time_as("ragged_decode_fp32_int8", lambda: RPA.ragged_paged_attention(
    q32, k8, v8, tables, ones, kv, 1 / math.sqrt(D), k_scales=ks,
    v_scales=vs))
f8k, f8v = (torch.clamp(x.float() / sc[..., None, None] * 448, -448, 448)
            .to(torch.float8_e4m3fn) for x, sc in ((k_pool, ks), (v_pool, vs)))
time_as("ragged_decode_fp8", lambda: RPA.ragged_paged_attention(
    q, f8k, f8v, tables, ones, kv, 1 / math.sqrt(D), k_scales=ks, v_scales=vs))
time_as("ragged_decode_fp32_fp8", lambda: RPA.ragged_paged_attention(
    q32, f8k, f8v, tables, ones, kv, 1 / math.sqrt(D), k_scales=ks,
    v_scales=vs))
del k8, v8, f8k, f8v
# the decode batch with pages of 12 keys (54 a row), bf16, fp32 and bf16
# over int8 pools
NB12, nb12 = 450, 54
t12 = torch.from_numpy(rng.permutation(np.arange(1, NB12))[:8 * nb12]
                       .reshape(8, nb12).astype(np.int32)).to(dev)
k12, v12 = rnd(H, NB12, 12, D), rnd(H, NB12, 12, D)
for qq, kk, vv, tag in ((q, k12, v12, ""),
                        (q32, k12.float(), v12.float(), "_fp32")):
    time_as("ragged_decode_bs12" + tag, lambda: RPA.ragged_paged_attention(
        qq, kk, vv, t12, ones, kv, 1 / math.sqrt(D)))
ks12, vs12 = (x.float().abs().amax((2, 3)) for x in (k12, v12))
k12, v12 = (torch.round(x.float() / sc[..., None, None] * 127).to(torch.int8)
            for x, sc in ((k12, ks12), (v12, vs12)))
time_as("ragged_decode_bs12_int8", lambda: RPA.ragged_paged_attention(
    q, k12, v12, t12, ones, kv, 1 / math.sqrt(D), k_scales=ks12,
    v_scales=vs12))
del k12, v12, q32
# fp32 queries over fp32 pools (phase 3's fp32 (a))
q32, k32, v32 = (t.float() for t in (q, k_pool, v_pool))
time_as("ragged_decode_fp32", lambda: RPA.ragged_paged_attention(
    q32, k32, v32, tables, ones, kv, 1 / math.sqrt(D)))
del q32, k32, v32
# D 256 in bf16 (a checkout that refuses it records None), and over int8
# and fp8 e4m3 pools with per-page absmax scales
q256, k256, v256 = rnd(8, 1, H, 256), rnd(H, NB, bs, 256), rnd(H, NB, bs, 256)
try:
    time_as("ragged_decode_d256", lambda: RPA.ragged_paged_attention(
        q256, k256, v256, tables, ones, kv, 1 / 16))
except (RuntimeError, ValueError):
    if want("ragged_decode_d256"):
        res["ragged_decode_d256"] = None
ks, vs = (x.float().abs().amax((2, 3)) for x in (k256, v256))
for pool, qmax, tag in ((torch.int8, 127.0, "int8"),
                        (torch.float8_e4m3fn, 448.0, "fp8")):
    kq, vq = (x.float() / sc[..., None, None] * qmax
              for x, sc in ((k256, ks), (v256, vs)))
    if pool == torch.int8:
        kq, vq = torch.round(kq), torch.round(vq)
    kq, vq = kq.to(pool), vq.to(pool)
    time_as(f"ragged_decode_d256_{tag}", lambda: RPA.ragged_paged_attention(
        q256, kq, vq, tables, ones, kv, 1 / 16, k_scales=ks, v_scales=vs))
    del kq, vq
del q256, k256, v256
# chip_smoke.py phase 3's case (b)
mt, ql_m, kv_m = mixed_batch(rng)
qm = rnd(4, 128, H, D)
time_as("ragged_mixed", lambda: RPA.ragged_paged_attention(
    qm, k_pool, v_pool, mt, ql_m, kv_m, 1 / math.sqrt(D)))
qm32, k32, v32 = (t.float() for t in (qm, k_pool, v_pool))
time_as("ragged_mixed_fp32", lambda: RPA.ragged_paged_attention(
    qm32, k32, v32, mt, ql_m, kv_m, 1 / math.sqrt(D)))
del qm32, k32, v32
qm256, k256, v256 = rnd(4, 128, H, 256), rnd(H, NB, bs, 256), rnd(H, NB, bs, 256)
try:
    time_as("ragged_mixed_d256", lambda: RPA.ragged_paged_attention(
        qm256, k256, v256, mt, ql_m, kv_m, 1 / 16))
except (RuntimeError, ValueError):
    if want("ragged_mixed_d256"):
        res["ragged_mixed_d256"] = None
del qm256, k256, v256
# fp32 queries at D 64 (the TF32 kernel's narrower width): the decode batch
# over fp32 and int8 pools, and the mixed batch
q64, k64, v64 = (torch.randn(*s, generator=gen, device=dev)
                 for s in ((8, 1, H, 64), (H, NB, bs, 64), (H, NB, bs, 64)))
time_as("ragged_decode_fp32_d64", lambda: RPA.ragged_paged_attention(
    q64, k64, v64, tables, ones, kv, 1 / 8))
ks, vs = (x.abs().amax((2, 3)) for x in (k64, v64))
k8, v8 = (torch.round(x / sc[..., None, None] * 127).to(torch.int8)
          for x, sc in ((k64, ks), (v64, vs)))
time_as("ragged_decode_fp32_int8_d64", lambda: RPA.ragged_paged_attention(
    q64, k8, v8, tables, ones, kv, 1 / 8, k_scales=ks, v_scales=vs))
qm64 = torch.randn(4, 128, H, 64, generator=gen, device=dev)
time_as("ragged_mixed_fp32_d64", lambda: RPA.ragged_paged_attention(
    qm64, k64, v64, mt, ql_m, kv_m, 1 / 8))
del q64, k64, v64, k8, v8, qm64

tf32_ragged()
time_as("paged_decode", lambda: PA.paged_decode_attention(
    q[:, 0], k_pool, v_pool, tables, kv, 1 / math.sqrt(D)))
q32, k32, v32 = (t.float() for t in (q[:, 0], k_pool, v_pool))
time_as("paged_decode_fp32", lambda: PA.paged_decode_attention(
    q32, k32, v32, tables, kv, 1 / math.sqrt(D)))
del q32, k32, v32
# dK/dV at chip_smoke.py phase 25's call, from the forward's lse and dQ's
# delta
for Dh, dt in ((256, bf), (160, bf), (256, torch.float16)):
    qf, kf, vf, dof = (rnd(8, 1024, 16, Dh).to(dt) for _ in range(4))
    sc = 1 / math.sqrt(Dh)
    _, lse = FA.flash_fwd(qf, kf, vf, True, sc)
    _, delta = FA.flash_bwd_dq(qf, kf, vf, lse, dof, True, sc)
    tag = "" if dt == bf else "_fp16"
    time_as(f"flash_dkv_d{Dh}{tag}", lambda: FA.flash_bwd_dkv(
        qf, kf, vf, lse, delta, dof, True, sc))
    del qf, kf, vf, dof, lse, delta
# fp32 dQ and dK/dV at chip_smoke.py phase 6 (a)'s call (B 8, S 1024, H 16,
# D 128, causal; q, k and v views of one qkv)
qkv = torch.randn(8, 1024, 16, 3, 128, generator=gen, device=dev)
qf, kf, vf = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
dof = torch.randn(8, 1024, 16, 128, generator=gen, device=dev)
sc = 1 / math.sqrt(128)
_, lse = FA.flash_fwd(qf, kf, vf, True, sc)
_, delta = FA.flash_bwd_dq(qf, kf, vf, lse, dof, True, sc)
time_as("flash_fwd_fp32", lambda: FA.flash_fwd(qf, kf, vf, True, sc))
time_as("flash_dq_fp32", lambda: FA.flash_bwd_dq(qf, kf, vf, lse, dof, True,
                                                  sc))
time_as("flash_dkv_fp32", lambda: FA.flash_bwd_dkv(qf, kf, vf, lse, delta, dof,
                                                    True, sc))
del qkv, qf, kf, vf, dof, lse, delta
tf32_flash()
p, g = rnd(24, 2048, 8192, scale=0.02), rnd(24, 2048, 8192, scale=1e-3)
slot = {"moment1": rnd(24, 2048, 8192, scale=1e-3),
        "moment2": rnd(24, 2048, 8192, scale=1e-3).square()}
time_as("fused_adam", lambda: FAD.adam_update(
    p, g, slot, 1e-4, 1, None, beta1=0.9, beta2=0.999, epsilon=1e-8,
    decoupled=0.01), runs=10)
time_as("fused_adam_sr", lambda: FAD.adam_update(
    p, g, slot, 1e-4, 1, (1, 7), beta1=0.9, beta2=0.999, epsilon=1e-8,
    decoupled=0.01), runs=10)
del p, g, slot
for rows in (5120, 41472):
    x, dy = rnd(rows, 768, scale=3.0), rnd(rows, 768)
    w = torch.randn(768, generator=gen, device=dev)
    b = torch.randn(768, generator=gen, device=dev)
    tag = "" if rows == 5120 else f"_{rows}"
    time_as("layer_norm_fwd" + tag, lambda: LN.layer_norm_fwd(x, w, b, 1e-12))
    # the whole backward (dx, dw, db) through the autograd Function
    xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
    yr = LN.layer_norm(xr, wr, br, 1e-12)
    time_as("layer_norm_bwd" + tag, lambda: torch.autograd.grad(
        yr, (xr, wr, br), dy, retain_graph=True))
    del xr, wr, br, yr
x, dy = rnd(8192, 2048, scale=3.0), rnd(8192, 2048)
w = torch.randn(2048, generator=gen, device=dev)
time_as("rms_norm_fwd", lambda: RN.rms_norm_fwd(x, w, 1e-5))
# the whole backward (dx and the fp32 dw) through the autograd Function,
# whatever kernels a checkout runs for it
xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
yr = RN.rms_norm(xr, wr, 1e-5)
time_as("rms_norm_bwd", lambda: torch.autograd.grad(yr, (xr, wr), dy,
                                                     retain_graph=True))
_, rstd = RN.rms_norm_fwd(x, w, 1e-5)
time_as("rms_norm_bwd_dx_only", lambda: RN.rms_norm_bwd(x, w, rstd, dy,
                                                         need_dw=False))
x16, dy16 = x.to(torch.float16), dy.to(torch.float16)
time_as("rms_norm_fwd_fp16", lambda: RN.rms_norm_fwd(x16, w, 1e-5))
time_as("rms_norm_bwd_dx_only_fp16", lambda: RN.rms_norm_bwd(
    x16, w, rstd, dy16, need_dw=False))
del xr, wr, yr, x16, dy16
# the LayerNorm forward at the primitives' flagship call and at BERT's rows,
# in the three dtypes, with a bias
for rows, Hn in ((8192, 2048), (5120, 768)):
    w = torch.randn(Hn, generator=gen, device=dev)
    b = torch.randn(Hn, generator=gen, device=dev)
    for dt, tag in ((bf, ""), (torch.float16, "_fp16"),
                    (torch.float32, "_fp32")):
        if rows == 5120 and dt == bf:
            continue     # layer_norm_fwd above
        x = rnd(rows, Hn, scale=3.0).to(dt)
        time_as(f"layer_norm_fwd_{rows}x{Hn}{tag}",
                lambda: LN.layer_norm_fwd(x, w, b, 1e-12))
        del x
x = rnd(8, 1024, 16, 128)
ang = torch.rand(1024, 64, generator=gen, device=dev)
time_as("rope", lambda: RP.rope(x, ang.cos(), ang.sin()))
print(json.dumps(res))
'''


def _run(root: Path, only: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _WORKER, str(root), only],
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--child", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the result names to "
                         "time (default: every call)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    runs = []
    for tag in ("parent", "child", "child", "parent"):
        res = _run(getattr(args, tag).resolve(), args.only)
        runs.append((tag, res))
        print(f"{tag}: " + "; ".join(
            f"{k} {'-' if t is None else f'{t:.4f}'}" for k, t in res.items())
            + " ms", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
