"""How far the fp32 flash backward and its plain version each sit from the
exact gradients, on the card: where the fp32 gate of ``chip_smoke.py`` and
``tests/test_torch_flash_fp32_hopper_cuda.py`` (5e-6 on the worst 64-row
tile, the denominator at least 1e-1 of the tile's terms) meets fp32's own
rounding.

    python3 -m paddle_tpu_torch.profiler.flash_fp32_error

The shape is the card test's that leaves a key tile with one key: causal
with Sq 97 > Sk 65 (query i sees keys up to i - 32; key 64 alone in its
tile, seen by query 96 only), H 2 / 2, at D 128, 160, 200 and 256, with no
mask operand, flashmask rows, rows with dropout, a bias, and a bias with
rows and dropout, over five seeds. For each case it prints the worst tile
of dq and dk (the card test's metric) between the kernels and the plain
fp32 version, between the kernels and the same arithmetic in float64 (the
plain version's masks and keep bits, the kernels' lse), and between the
plain fp32 version and float64; then the maxima and how many cases pass
5e-6 in each. Prints the card's name and power limit first.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

from ..kernels import _build
from ..kernels import flash_attention as FA

TOL = 5e-6
DIMS = (128, 160, 200, 256)
VARIANTS = ("none", "rows", "rows_dropout", "bias", "bias_rows_dropout")
SEEDS = range(5)


def tile_rel(got, ref, terms, rows=64):
    """Worst ||got - ref|| / max(||ref||, 1e-1 ||terms||) over 64-row tiles
    of dim 1 and each head of a [B, S, H, D] tensor (the card test's)."""
    d, r, t = (x.double() for x in (got.double() - ref.double(), ref, terms))
    pad = -d.shape[1] % rows
    d, r, t = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
               for x in (d, r, t))
    B, S, H, D = d.shape
    dd, rr, tt = (x.reshape(B, S // rows, rows, H, D).square().sum((2, 4))
                  for x in (d, r, t))
    rr = torch.maximum(rr, 1e-2 * tt)
    ratio = torch.where(rr > 0, (dd / rr.clamp_min(1e-300)).sqrt(),
                        torch.where(dd > 0, math.inf, 0.0))
    return ratio.max().item()


def case(D, variant, seed):
    """(B, Sq, Sk, H, causal) inputs and the variant's kwargs."""
    rng = np.random.RandomState(1000 * seed + D)
    B, Sq, Sk, H = 2, 97, 65, 2
    q, do = (torch.from_numpy(rng.randn(B, Sq, H, D).astype(np.float32))
             .cuda() for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(B, Sk, H, D).astype(np.float32))
            .cuda() for _ in range(2))
    var = {}
    if "bias" in variant:
        bias = rng.randn(B, 1, Sq, Sk).astype(np.float32)
        var["bias"] = torch.from_numpy(bias).cuda()
    if "rows" in variant:
        start = rng.randint(0, Sq, (B, 1, Sk))
        end = np.minimum(start + rng.randint(1, 60, start.shape), Sq)
        var["fm"] = (torch.from_numpy(start.astype(np.int32)).cuda(),
                     torch.from_numpy(end.astype(np.int32)).cuda())
    if "dropout" in variant:
        var.update(dropout_p=0.2, seed=4242 + seed)
    return q, k, v, do, var


def exact(q, k, v, do, lse, scale, var, p32, pk32):
    """dq, dk in float64 from the plain version's masks and keep bits."""
    g = q.shape[2] // k.shape[2]
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    kf, vf = (t.repeat_interleave(g, dim=2) for t in (k64, v64))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, kf) * scale
    if "bias" in var:
        s = s + var["bias"].double()
    zero = torch.zeros((), dtype=torch.float64, device=q.device)
    p = torch.where(p32 > 0, torch.exp(s - lse.double()[..., None]), zero)
    dp = torch.einsum("bqhd,bkhd->bhqk", do64, vf)
    if var.get("dropout_p"):
        dp = torch.where(pk32 > 0, dp / (1.0 - var["dropout_p"]), zero)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q64)
    B, Sk, Hkv, D = k.shape
    return dq, dk.reshape(B, Sk, Hkv, g, D).sum(3)


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    worst = {"kernel-plain": [], "kernel-fp64": [], "plain-fp64": []}
    for D in DIMS:
        for variant in VARIANTS:
            for seed in SEEDS:
                q, k, v, do, var = case(D, variant, seed)
                scale = 1.0 / math.sqrt(D)
                fwd = {n: var[n] for n in ("bias", "fm", "dropout_p", "seed")
                       if n in var}
                _, lse = FA.flash_fwd(q, k, v, True, scale, **fwd)
                dq, delta = FA.flash_bwd_dq(q, k, v, lse, do, True, scale,
                                            **var)
                dk, _ = FA.flash_bwd_dkv(q, k, v, lse, delta, do, True,
                                         scale, **var)
                args = (q, k, v, lse, do, True, scale, None, None, None,
                        var.get("dropout_p", 0.0), var.get("seed", 0),
                        var.get("bias"), var.get("fm"), None)
                dq_p, dk_p, _, delta_p, _ = FA._plain_bwd(*args)
                p, pk, dp = FA._bwd_probs(*args[:7], *args[8:12],
                                          bias=args[12], fm=args[13])
                mag = p.abs() * (dp.abs() + delta_p.abs()[..., None]) * scale
                tq = torch.einsum("bhqk,bkhd->bqhd", mag, k.abs())
                tk = torch.einsum("bhqk,bqhd->bkhd", mag, q.abs())
                dq64, dk64 = exact(q, k, v, do, lse, scale, var, p, pk)
                row = {}
                pairs = {"kernel-plain": ((dq, dk), (dq_p, dk_p)),
                         "kernel-fp64": ((dq, dk), (dq64, dk64)),
                         "plain-fp64": ((dq_p, dk_p), (dq64, dk64))}
                for name, (a, b) in pairs.items():
                    row[name] = (tile_rel(a[0], b[0], tq),
                                 tile_rel(a[1], b[1], tk))
                    worst[name].append(max(row[name]))
                print(f"D {D} {variant} seed {seed}: " + "; ".join(
                    f"{n} dq {e[0]:.2e} dk {e[1]:.2e}"
                    for n, e in row.items()), flush=True)
    for name, errs in worst.items():
        print(f"{name}: worst {max(errs):.2e}, {sum(e <= TOL for e in errs)} "
              f"of {len(errs)} cases within {TOL:g}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
