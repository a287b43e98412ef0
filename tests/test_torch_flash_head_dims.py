"""Head dims and dtypes of the port's flash attention
(``paddle_tpu_torch.kernels.flash_attention``) against the JAX package's
Pallas flash kernel, run in interpret mode on the CPU: D in {32, 40, 80, 96,
256} in fp32 and bf16, and fp16, forward and the q / k / v gradients; and
the rules the port adds around the kernels: the shape route of
``scaled_dot_product_attention`` (D above 256 to the composed path, as the
JAX gate ``supported`` sends it), the kernels' dtype and head-dim checks, and
the zero-padded copy of a head whose row is not a whole number of 16-byte
words.

On the CPU the port's wrappers take the kernels' plain PyTorch versions
(``flash_fwd_plain`` / ``flash_bwd_plain``), which ``chip_smoke.py`` phase
25 and ``test_torch_flash_bias_kernels_cuda.py`` hold the CUDA kernels to
on the card at every one of these D and dtypes. Tolerances are those of
``test_flash_training.py`` on the max-abs-relative error: fp32 2e-5 (out)
and 2e-4 (grads); bf16 and fp16 2e-2 and 5e-2.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas import flash_attention as JFA
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as FA

JNF = importlib.import_module("paddle_tpu.nn.functional.flash_attention")
TNF = importlib.import_module("paddle_tpu_torch.nn.functional.flash_attention")

TOL = {"fp32": (2e-5, 2e-4), "bf16": (2e-2, 5e-2), "fp16": (2e-2, 5e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16, "fp16": jnp.float16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16,
       "fp16": torch.float16}


def _inputs(D, seed, B=1, S=128, H=2, Hkv=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, Hkv, D).astype(np.float32),
            rng.randn(B, S, H, D).astype(np.float32))


def _close(got, ref, tol, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) / scale
    assert err <= tol, (what, err, tol)


def _both(q, k, v, do, causal, dt):
    """(out, [dq, dk, dv]) of the JAX kernel (interpret mode) and of the
    port, each as fp32 numpy, from the same inputs in ``dt``."""
    jargs = [jnp.asarray(a).astype(JDT[dt]) for a in (q, k, v)]
    out_j, vjp = jax.vjp(
        lambda a, b, c: JFA.flash_attention(a, b, c, causal=causal), *jargs)
    g_j = vjp(jnp.asarray(do).astype(out_j.dtype))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    t = [torch.from_numpy(a).to(TDT[dt]).requires_grad_(True)
         for a in (q, k, v)]
    out_t = FA.flash_attention(*t, causal=causal)
    assert out_t.dtype == TDT[dt] and out_t.shape == t[0].shape
    g_t = torch.autograd.grad(out_t, t, torch.from_numpy(do).to(TDT[dt]))
    return ((f32(out_j), [f32(g) for g in g_j]),
            (out_t.detach().float().numpy(), [g.float().numpy()
                                               for g in g_t]))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("D", [32, 40, 80, 96, 256])
def test_head_dims_match_jax_kernel(D, dt):
    q, k, v, do = _inputs(D, seed=D)
    (out_j, g_j), (out_t, g_t) = _both(q, k, v, do, D % 64 != 0, dt)
    tol_o, tol_g = TOL[dt]
    _close(out_t, out_j, tol_o, "out")
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        _close(a, b, tol_g, name)


@pytest.mark.parametrize("D,Hkv", [(64, 2), (96, 1)])
def test_fp16_matches_jax_kernel(D, Hkv):
    q, k, v, do = _inputs(D, seed=7, H=2, Hkv=Hkv)
    (out_j, g_j), (out_t, g_t) = _both(q, k, v, do, True, "fp16")
    tol_o, tol_g = TOL["fp16"]
    _close(out_t, out_j, tol_o, "out")
    for name, a, b in zip(("dq", "dk", "dv"), g_t, g_j):
        _close(a, b, tol_g, name)


def test_sdpa_above_256_is_the_composed_path():
    """D 320: the JAX gate sends it to the composed _sdpa_reference; so does
    the port (on the CPU always, on the card by shape)."""
    q, k, v, _ = _inputs(320, seed=1, S=24)
    ref = np.asarray(JNF._sdpa_reference(*(jnp.asarray(a) for a in (q, k, v)),
                                         is_causal=True))
    out = TNF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_route_is_decided_by_shape_alone():
    """On a device other than the CPU (a meta tensor stands for the card
    here: no data is read) D <= 256 takes the kernels and D > 256 the
    counted composed path, before anything is launched; the CPU is always
    composed and not counted."""
    before = TNF.scaled_dot_product_attention.COMPOSED
    for D, composed in ((1, False), (64, False), (256, False), (257, True),
                        (320, True)):
        q = torch.empty(1, 8, 2, D, device="meta")
        assert TNF._composed_here(q) is composed, D
    assert TNF.scaled_dot_product_attention.COMPOSED == before + 2
    assert TNF._composed_here(torch.zeros(1, 8, 2, 320))
    assert TNF.scaled_dot_product_attention.COMPOSED == before + 2


def test_kernel_checks_and_row_padding():
    """What the kernels refuse (the checks run before any launch) and the
    layout step for a row off the 16-byte word: a zero-padded contiguous
    copy whose extra columns add nothing to q k^T."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(TypeError, match="float64"):
        FA._check_cuda(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="int32"):
        FA._check_cuda(q.int(), q.int(), q.int())
    q320 = torch.zeros(1, 8, 2, 320)
    with pytest.raises(ValueError, match="256"):
        FA._check_cuda(q320, q320, q320)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        FA._check_cuda(q.to(dt), q.to(dt), q.to(dt))
    assert _build.FLASH_D_PADS == (32, 64, 96, 128, 192, 256)
    assert [FA._row_width(D, 2) for D in (1, 8, 33, 64, 250)] == \
        [8, 8, 40, 64, 256]
    assert [FA._row_width(D, 4) for D in (1, 5, 64, 250)] == [4, 8, 64, 252]
    x = torch.randn(2, 10, 3, 33, dtype=torch.bfloat16)
    (p,) = FA._padded(40, x)
    assert p.shape == (2, 10, 3, 40) and p.is_contiguous()
    assert torch.equal(p[..., :33], x) and (p[..., 33:] == 0).all()
    view = torch.randn(2, 10, 3, 3, 64)[:, :, :, 0]     # head-major qkv view
    (same,) = FA._padded(64, view)
    assert same.data_ptr() == view.data_ptr()           # read in place
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 2, 33).astype(np.float32))
               for _ in range(3))
    out = FA.flash_fwd_plain(q, k, v, True, 0.2)[0]
    padded = FA.flash_fwd_plain(*FA._padded(36, q, k, v), True, 0.2)[0]
    torch.testing.assert_close(padded[..., :33], out, rtol=0, atol=1e-6)
