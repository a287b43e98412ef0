"""Every float dtype a JAX kernel gate admits, the port's kernels take.

The JAX package routes float32, bfloat16 and float16 into its LayerNorm,
RMSNorm, RoPE and Adam kernels (``layer_norm.py`` / ``rms_norm.py`` /
``rope.py`` ``supported``, ``fused_adam.py`` ``supported``: every array
floating, each in its own dtype) and into the paged and ragged attention
kernels (no dtype gate). On the card the port's wrappers run the dtype
checks below before a launch; these tests call those checks on CPU tensors,
so they show here what raised ``TypeError`` on the card for float16 (and
for an Adam gradient in another dtype than p).

They also hold the plain versions at float16, which the card holds the CUDA
kernels to, against the JAX kernels in interpret mode, at the fp16
tolerance of the flash tests (``test_torch_flash_head_dims.py``): max-abs
error over max(max-abs reference, 1) within 2e-2. Inputs are made with
numpy from a seed. The CUDA kernels at float16 are tested on the card by
``test_torch_kernel_dtypes_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.pallas.fused_adam as JFA
import paddle_tpu.kernels.pallas.layer_norm as JLN
import paddle_tpu.kernels.pallas.rms_norm as JRN
import paddle_tpu.kernels.pallas.rope as JR
from paddle_tpu.kernels.pallas.paged_attention import (
    paged_decode_attention as jax_paged)
from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_ragged)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_adam as FAD
from paddle_tpu_torch.kernels import layer_norm as TLN
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.kernels import rms_norm as TRN
from paddle_tpu_torch.kernels import rope as TR

DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
FP16_TOL = 2e-2


def _close(got, ref, tol=FP16_TOL, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1.0)
    assert err <= tol, (what, err, tol)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the dtype checks the card path runs, against the JAX gates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", list(DTYPES))
def test_row_kernel_checks_admit_what_the_jax_gates_admit(dt):
    tdt, jdt = DTYPES[dt]
    x = torch.zeros(4, 64, dtype=tdt)
    w = torch.ones(64)
    jx, jw = jnp.zeros((4, 64), jdt), jnp.ones((64,), jnp.float32)
    assert JLN.supported(jx, jw) and JRN.supported(jx, jw)
    assert _build.dtype_code(x, "x") == list(DTYPES).index(dt)
    assert _build.check_rows(x, "layer_norm", w, w) == _build.dtype_code(
        x, "x")
    code, w32 = TRN._check(x, w)
    assert code == _build.dtype_code(x, "x") and w32.dtype == torch.float32
    x4 = torch.zeros(2, 3, 4, 8, dtype=tdt)
    assert JR.supported(jnp.zeros((2, 3, 4, 8), jdt), None, None)
    assert TR.supported(x4, None, None)
    assert _build.dtype_code(x4, "rope") == _build.dtype_code(x, "x")


def test_row_kernel_checks_refuse_what_no_kernel_takes():
    for dt in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            _build.check_rows(torch.zeros(4, 64, dtype=dt), "layer_norm")


@pytest.mark.parametrize("p,g,m1,m2", [
    ("fp16", "fp16", "fp16", "fp16"), ("fp16", "fp16", "fp32", "fp32"),
    ("bf16", "fp32", "bf16", "bf16"), ("fp32", "bf16", "fp32", "fp32"),
    ("fp32", "fp16", "bf16", "fp32"), ("bf16", "fp16", "fp16", "bf16")])
def test_adam_check_admits_every_float_dtype_mix(p, g, m1, m2):
    """The JAX gate takes each of p, g, moment1 and moment2 floating, each in
    its own dtype; so does the kernel's check."""
    shape = (256, 256)
    mk = lambda dt: torch.zeros(shape, dtype=DTYPES[dt][0])
    jmk = lambda dt: jnp.zeros(shape, DTYPES[dt][1])
    slot = {"moment1": mk(m1), "moment2": mk(m2)}
    assert JFA.supported(jmk(p), jmk(g), {"moment1": jmk(m1),
                                           "moment2": jmk(m2)})
    assert FAD.supported(mk(p), mk(g), slot)
    FAD._check_cuda(mk(p), mk(g), slot)
    with pytest.raises(TypeError, match="float64"):
        FAD._check_cuda(mk(p), mk(g).double(), slot)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_kernel_checks_admit_float_queries(dt):
    tdt = DTYPES[dt][0]
    q = torch.zeros(4, 4, 16, dtype=tdt)
    pool = torch.zeros(4, 8, 8, 16, dtype=tdt)
    tables = torch.zeros(4, 2, dtype=torch.int32)
    lens = torch.zeros(4, dtype=torch.int32)
    PA._check_cuda(q, pool, pool, tables, lens)
    RPA._check_cuda(q[:, None], pool, pool, tables, lens, lens)


# ---------------------------------------------------------------------------
# the plain versions at float16 against the JAX kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_bias", [True, False])
def test_layer_norm_plain_fp16_matches_jax_kernel(with_bias):
    x, w, b = _rand((6, 40, 256)), _rand((256,), 1), _rand((256,), 2)
    xt = torch.from_numpy(x).half().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if with_bias else None
    y = TLN.layer_norm(xt, wt, bt, 1e-5)
    ref = JLN.layer_norm(jnp.asarray(x, jnp.float16), jnp.asarray(w),
                         jnp.asarray(b) if with_bias else None, 1e-5)
    assert y.dtype == torch.float16 and ref.dtype == jnp.float16
    _close(y.detach().float().numpy(), ref.astype(jnp.float32), what="y")


def test_rms_norm_plain_fp16_matches_jax_kernel():
    x, w = _rand((6, 40, 256)), _rand((256,), 1)
    y = TRN.rms_norm(torch.from_numpy(x).half(), torch.from_numpy(w), 1e-6)
    ref = JRN.rms_norm(jnp.asarray(x, jnp.float16), jnp.asarray(w), 1e-6)
    assert y.dtype == torch.float16 and ref.dtype == jnp.float16
    _close(y.float().numpy(), ref.astype(jnp.float32), what="y")


def test_rope_plain_fp16_matches_jax_kernel():
    x = _rand((2, 16, 4, 64))
    ang = np.random.RandomState(1).uniform(-3, 3, (16, 32))
    c, s = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    y = TR.apply_rope(torch.from_numpy(x).half(), torch.from_numpy(c),
                      torch.from_numpy(s))
    ref = JR.apply_rope(jnp.asarray(x, jnp.float16), jnp.asarray(c),
                        jnp.asarray(s))
    assert y.dtype == torch.float16
    _close(y.float().numpy(), ref.astype(jnp.float32), what="y")


@pytest.mark.parametrize("p,g,m", [("fp16", "fp16", "fp16"),
                                   ("bf16", "fp32", "bf16"),
                                   ("fp16", "fp32", "fp32")])
def test_adam_plain_fp16_and_mixed_gradient_match_jax_kernel(p, g, m):
    shape = (256, 256)
    rng = np.random.RandomState(0)
    arrs = {"p": rng.randn(*shape), "g": rng.randn(*shape) * 0.01,
            "moment1": rng.randn(*shape) * 0.01,
            "moment2": np.abs(rng.randn(*shape)) * 1e-4}
    dts = {"p": p, "g": g, "moment1": m, "moment2": m}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(DTYPES[dts[k]][0])
         for k, v in arrs.items()}
    j = {k: jnp.asarray(v, jnp.float32).astype(DTYPES[dts[k]][1])
         for k, v in arrs.items()}
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=0.01)
    slot = {"moment1": t["moment1"], "moment2": t["moment2"]}
    FAD.adam_update(t["p"], t["g"], slot, 1e-3, 3, None, **kw)
    rp, rs = JFA.adam_update(j["p"], j["g"], {"moment1": j["moment1"],
                                               "moment2": j["moment2"]},
                             1e-3, jnp.asarray(3, jnp.int32), None, **kw)
    assert t["p"].dtype == DTYPES[p][0] and t["g"].dtype == DTYPES[g][0]
    _close(t["p"].float().numpy(), rp.astype(jnp.float32), what="p")
    for k in ("moment1", "moment2"):
        _close(slot[k].float().numpy(), rs[k].astype(jnp.float32), what=k)


def test_paged_and_ragged_plain_fp16_match_jax_kernels():
    rng = np.random.RandomState(0)
    hq, hkv, D, bs, nb, NB = 8, 2, 16, 8, 5, 32
    k_pool = rng.randn(hkv, NB, bs, D).astype(np.float32)
    v_pool = rng.randn(hkv, NB, bs, D).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB))[:4 * nb].reshape(4, nb) \
        .astype(np.int32)
    lens = np.array([19, 0, 16, 9], np.int32)
    q = rng.randn(4, hq, D).astype(np.float32)
    scale = 1.0 / np.sqrt(D)
    h = lambda a: torch.from_numpy(a).half()
    jh = lambda a: jnp.asarray(a, jnp.float16)
    out = PA.paged_decode_attention(h(q), h(k_pool), h(v_pool),
                                    torch.from_numpy(tables),
                                    torch.from_numpy(lens), scale)
    ref = jax_paged(jh(q), jh(k_pool), jh(v_pool), jnp.asarray(tables),
                    jnp.asarray(lens), scale)
    assert out.dtype == torch.float16
    _close(out.float().numpy(), ref.astype(jnp.float32), what="decode")
    q_lens = np.array([1, 3, 0, 2], np.int32)
    qr = rng.randn(4, 3, hq, D).astype(np.float32)
    out = RPA.ragged_paged_attention(
        h(qr), h(k_pool), h(v_pool), torch.from_numpy(tables),
        torch.from_numpy(q_lens), torch.from_numpy(lens), scale)
    ref = jax_ragged(jh(qr), jh(k_pool), jh(v_pool), jnp.asarray(tables),
                     jnp.asarray(q_lens), jnp.asarray(lens), scale)
    assert out.dtype == torch.float16
    _close(out.float().numpy(), ref.astype(jnp.float32), what="ragged")
