"""The port's LayerNorm (``paddle_tpu_torch.kernels.layer_norm`` and the
registry op ``nn.functional.layer_norm``) against the JAX package's Pallas
``layer_norm`` in interpret mode and its composed ``F.layer_norm``.

On the CPU the port's wrappers take the kernels' plain PyTorch versions,
which follow the Pallas kernel's arithmetic (fp32 statistics and affine, one
rounding), so these tests hold what ``chip_smoke.py`` compares the CUDA
kernels with on the card to the JAX kernel. Shapes and tolerances are those
of ``test_pallas_layer_norm.py``: fp32 forward 2e-6, bf16 forward 0.03,
gradients 2e-5. Inputs are made with numpy from a seed and handed to both
packages. The CUDA kernels are tested on the card by
``test_torch_bert_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.pallas.layer_norm as JLN
from paddle_tpu_torch import device_guard
from paddle_tpu_torch.kernels import layer_norm as TLN
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.nn import functional as TF

JF = importlib.import_module("paddle_tpu.nn.functional.norm")

SHAPES = [((6, 40), 768), ((37,), 256), ((1, 1), 128)]


def _inputs(lead, h, with_bias, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(*lead, h).astype(np.float32)
    w = r.randn(h).astype(np.float32)
    b = r.randn(h).astype(np.float32) if with_bias else None
    return x, w, b


def _t(a, dtype=torch.float32, grad=False):
    return None if a is None else torch.from_numpy(a).to(dtype) \
        .requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("lead,h", SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("eps", [1e-12, 1e-5])
def test_forward_matches_jax_kernel_and_composed_fp32(lead, h, with_bias,
                                                      eps):
    x, w, b = _inputs(lead, h, with_bias)
    y = TLN.layer_norm(_t(x), _t(w), _t(b), eps)
    ref_k = np.asarray(JLN.layer_norm(_j(x), _j(w), _j(b), eps))
    ref_c = np.asarray(JF.layer_norm(_j(x), (h,), _j(w), _j(b), eps))
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), ref_k, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(y.numpy(), ref_c, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("lead,h", SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_bf16_rows_keep_their_dtype_beside_fp32_affine(lead, h, with_bias):
    """The dtype contract: bf16 rows with fp32 weight and bias give bf16,
    as the Pallas kernel computes it (fp32 throughout, one rounding)."""
    x, w, b = _inputs(lead, h, with_bias, seed=1)
    y = TLN.layer_norm(_t(x, torch.bfloat16), _t(w), _t(b), 1e-12)
    ref = JLN.layer_norm(_j(x, jnp.bfloat16), _j(w), _j(b), 1e-12)
    assert y.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0.03, atol=0.03)
    # the registry op and the layer keep the contract
    with device_guard("cpu"):
        ln = LayerNorm(h, epsilon=1e-12)
    assert ln.weight.dtype == torch.float32
    assert ln(_t(x, torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("lead,h", [((13,), 256), ((6, 40), 768),
                                    ((1, 1), 128)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_grads_match_jax_kernel(lead, h, with_bias):
    """dx from the backward kernel's plain version, dw and db from the fp32
    cross-row sums, against jax.grad through the Pallas kernel (interpret
    mode) and through the composed op."""
    x, w, b = _inputs(lead, h, with_bias, seed=2)
    dy = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    xt, wt, bt = _t(x, grad=True), _t(w, grad=True), _t(b, grad=with_bias)
    y = TLN.layer_norm(xt, wt, bt, 1e-6)
    got = torch.autograd.grad(y, [t for t in (xt, wt, bt) if t is not None],
                              torch.from_numpy(dy))
    argnums = (0, 1, 2) if with_bias else (0, 1)
    for fn in (lambda x_, w_, b_=None: JLN.layer_norm(x_, w_, b_, 1e-6),
               lambda x_, w_, b_=None: JF.layer_norm(x_, (h,), w_, b_, 1e-6)):
        ref = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(dy)),
                       argnums=argnums)(*[_j(a) for a in (x, w, b)
                                          if a is not None])
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                       atol=2e-5)


# the card's held-row forward (csrc/layer_norm.cu ln_fwd_held) takes rows of
# whole 16-byte words, at most 8 a lane: bf16 H 2048 is held and 2056 is
# not; fp32 H 1024 is held and 1028 is not. Row counts that are no multiple
# of the persistent grid's warps.
HELD_EDGES = [((37,), 2048, "bf16"), ((13,), 2056, "bf16"),
              ((3, 13), 1024, "fp32"), ((13,), 1028, "fp32")]


@pytest.mark.parametrize("lead,h,dt", HELD_EDGES,
                         ids=[f"{dt}-{h}" for _, h, dt in HELD_EDGES])
@pytest.mark.parametrize("with_bias", [True, False])
def test_forward_matches_jax_kernel_at_held_row_edges(lead, h, dt,
                                                      with_bias):
    x, w, b = _inputs(lead, h, with_bias, seed=7)
    tdt, jdt = ((torch.float32, jnp.float32) if dt == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    y = TLN.layer_norm(_t(x, tdt), _t(w), _t(b), 1e-5)
    ref = JLN.layer_norm(_j(x, jdt), _j(w), _j(b), 1e-5)
    assert y.dtype == tdt and y.shape == x.shape
    tol = 2e-6 if dt == "fp32" else 0.03
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_no_bias_backward_returns_no_db_and_plain_parts_agree():
    x, w, _ = _inputs((8,), 128, False, seed=4)
    dy = np.random.RandomState(5).randn(8, 128).astype(np.float32)
    y, mean, rstd = TLN.layer_norm_fwd_plain(_t(x), _t(w), None, 1e-6)
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (8,)
    dx, dw, db = TLN.layer_norm_bwd_plain(_t(x), _t(w), mean, rstd,
                                          _t(dy), has_bias=False)
    assert db is None
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(TLN.layer_norm_bwd(_t(x), _t(w), mean, rstd,
                                          _t(dy), need_db=False)[0], dx)
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    gx, gw = torch.autograd.grad(TLN.layer_norm(xt, wt, None, 1e-6), (xt, wt),
                                 _t(dy))
    torch.testing.assert_close(gx, dx, rtol=0, atol=0)
    torch.testing.assert_close(gw, dw, rtol=1e-6, atol=1e-6)


def test_registry_op_without_weight_takes_the_composed_path():
    """No weight: the JAX gate refuses the kernel, so both packages run the
    composed op."""
    x, _, b = _inputs((4,), 64, True, seed=6)
    got = TF.layer_norm(_t(x), 64, None, _t(b), 1e-5)
    ref = JF.layer_norm(_j(x), (64,), None, _j(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)
