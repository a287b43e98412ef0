"""The fp32 flash backward on the card against its plain version, quickly:
the first check of a change to the fp32 dQ / dK/dV kernels.

    python3 -m paddle_tpu_torch.profiler.flash_fp32_check

The worst 64-row tile's relative l2 of dq, dk and dv (and the d-bias's l2)
against ``flash_bwd_plain`` at 14 small cases (D 32-256, causal and not, GQA
8/2, a bias, segments with dropout, a window with flashmask rows) and at
four full-size calls (B 8, S 1024, H 16 causal at D 128, 160 and 256; B 2,
GQA 16/4 at D 128), each against ``chip_smoke.py``'s fp32 gate of 5e-6;
then dQ and dK/dV at the GPT call (B 8, S 1024, H 16, causal) at D 128,
160 and 256, the median of 10 CUDA-event
timings after 2 warm calls, the L2 not evicted (``chip_smoke.py`` and
``kernels_ab.py`` evict it: their times are the ones to compare across
checkouts). Prints the card's name and power limit first.
"""

from __future__ import annotations

import math
import subprocess

import torch

from ..kernels import _build
from ..kernels import flash_attention as FA

TOL = 5e-6


def tile_rel_err(got, ref, rows=64):
    r = ref.float()
    d = got.float() - r
    pad = -d.shape[1] % rows
    d, r = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (d, r))
    B, S, H, D = d.shape
    dd, rr = (t.reshape(B, S // rows, rows, H, D).square().sum((2, 4))
              for t in (d, r))
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-30)).sqrt(),
                        torch.where(dd > 0, math.inf, 0.0))
    return ratio.max().item()


# name, B, Sq, Sk, H, H_kv, D, causal, variant
CASES = (
    ("D64 causal", 2, 256, 256, 4, 4, 64, True, {}),
    ("D128 S200 noncausal", 2, 200, 200, 4, 4, 128, False, {}),
    ("D128 GQA 8/2 sq128 sk256 causal", 1, 128, 256, 8, 2, 128, True, {}),
    ("D32", 1, 100, 100, 2, 2, 32, True, {}),
    ("D96", 1, 100, 300, 2, 2, 96, False, {}),
    ("D40 bias", 2, 130, 130, 2, 2, 40, True, {"bias": True}),
    ("D64 seg drop", 2, 256, 256, 2, 2, 64, False, {"seg": True, "drop": 0.2}),
    ("D128 window fm", 1, 256, 256, 2, 2, 128, False,
     {"window": (70, 5), "fm": True}),
    ("D256 causal", 2, 256, 256, 4, 4, 256, True, {}),
    ("D160 GQA 8/2 sq100 sk300", 1, 100, 300, 8, 2, 160, False, {}),
    ("D256 bias", 2, 130, 97, 2, 2, 256, True, {"bias": True}),
    ("D160 seg drop", 2, 256, 256, 2, 2, 160, False,
     {"seg": True, "drop": 0.2}),
    ("D256 window fm", 1, 256, 256, 2, 2, 256, False,
     {"window": (70, 5), "fm": True}),
    ("D200 bias seg drop GQA 4/2", 1, 200, 200, 4, 2, 200, True,
     {"bias": True, "seg": True, "drop": 0.1}),
)


def _variant(opt, B, sq, sk, rnd, gen):
    var = {}
    if opt.get("bias"):
        var["bias"] = rnd(B, 1, sq, sk)
    if opt.get("seg"):
        ids = torch.arange(sq, device="cuda") // 100
        var["q_seg"] = var["kv_seg"] = ids.expand(B, sq).contiguous().int()
    if opt.get("drop"):
        var.update(dropout_p=opt["drop"], seed=7)
    if opt.get("window"):
        var["window"] = opt["window"]
    if opt.get("fm"):
        st = torch.randint(0, sq, (B, 1, sk), generator=gen,
                           device="cuda").int()
        var["fm"] = (st, torch.minimum(st + 40, torch.tensor(
            sq, device="cuda")).int())
    return var


def _ms(fn, n=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[n // 2]


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.load_library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda")
    fails = 0
    for name, B, sq, sk, H, Hkv, D, causal, opt in CASES:
        q, k, v, do = (rnd(B, sq, H, D), rnd(B, sk, Hkv, D),
                       rnd(B, sk, Hkv, D), rnd(B, sq, H, D))
        var = _variant(opt, B, sq, sk, rnd, gen)
        sc = 1 / math.sqrt(D)
        fwd = {n: var[n] for n in ("bias", "q_seg", "kv_seg", "dropout_p",
                                   "seed", "fm", "window") if n in var}
        _, lse = FA.flash_fwd(q, k, v, causal, sc, **fwd)
        bg = "bias" in var
        dq, delta, *db = FA.flash_bwd_dq(q, k, v, lse, do, causal, sc,
                                         bias_grad=bg, **var)
        dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, causal, sc, **var)
        torch.cuda.synchronize()
        ref = FA.flash_bwd_plain(q, k, v, lse, do, causal, sc, bias_grad=bg,
                                 **var)
        errs = [tile_rel_err(x, y) for x, y in ((dq, ref[0]), (dk, ref[1]),
                                                (dv, ref[2]))]
        msg = ""
        if bg:
            dbr = FA._reduce_dbias(db[0], var["bias"])
            l2 = ((dbr - ref[3]).norm() / ref[3].norm()).item()
            errs.append(l2)
            msg = f" dbias {l2:.2e}"
        bad = max(errs) > TOL
        fails += bad
        design = FA.kernel_plan("flash_bwd_dkv", D, torch.float32)["design"]
        print(f"{name}: plan {design} dq {errs[0]:.2e} dk {errs[1]:.2e} dv "
              f"{errs[2]:.2e}{msg} {'FAIL' if bad else 'ok'}", flush=True)
    for B, S, H, Hkv, D in ((8, 1024, 16, 16, 128), (2, 1024, 16, 4, 128),
                            (8, 1024, 16, 16, 160), (8, 1024, 16, 16, 256)):
        q, do = rnd(B, S, H, D), rnd(B, S, H, D)
        k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        sc = 1 / math.sqrt(D)
        _, lse = FA.flash_fwd(q, k, v, True, sc)
        dq, delta = FA.flash_bwd_dq(q, k, v, lse, do, True, sc)
        dk, dv = FA.flash_bwd_dkv(q, k, v, lse, delta, do, True, sc)
        ref = FA.flash_bwd_plain(q, k, v, lse, do, True, sc)
        errs = [tile_rel_err(x, y) for x, y in ((dq, ref[0]), (dk, ref[1]),
                                                (dv, ref[2]))]
        fails += max(errs) > TOL
        print(f"full size B{B} S{S} H{H}/{Hkv} D{D}: dq {errs[0]:.2e} dk "
              f"{errs[1]:.2e} dv {errs[2]:.2e}", flush=True)
        del ref
    print("fails", fails)
    for D in (128, 160, 256):
        B, S, H = 8, 1024, 16
        q, k, v, do = (rnd(B, S, H, D) for _ in range(4))
        sc = 1 / math.sqrt(D)
        _, lse = FA.flash_fwd(q, k, v, True, sc)
        _, delta = FA.flash_bwd_dq(q, k, v, lse, do, True, sc)
        print(f"GPT call fp32 D {D}: dq ms",
              round(_ms(lambda: FA.flash_bwd_dq(q, k, v, lse, do, True,
                                                sc)), 4),
              "dkv ms", round(_ms(lambda: FA.flash_bwd_dkv(
                  q, k, v, lse, delta, do, True, sc)), 4), flush=True)
        del q, k, v, do, lse, delta
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
