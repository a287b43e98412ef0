"""The port's RoPE (``paddle_tpu_torch.kernels.rope``) and incubate's fused
ops (``paddle_tpu_torch.incubate.nn.functional``) against the JAX package's
Pallas ``apply_rope`` in interpret mode and its
``paddle_tpu.incubate.nn.functional``.

On the CPU ``rope`` takes the kernel's plain PyTorch version (fp32
rotation, one rounding to x's dtype), so these tests hold what
``chip_smoke.py`` compares the CUDA kernel with on the card to the JAX
kernel. Tolerance 1e-5 (``test_pallas_kernels.py``'s) for the kernel and
every rotation branch at fp32; bf16 within one bf16 ulp (both round once
from the same fp32 products). Tables made by each package from theta 10000
differ by the last bits of fp32 ``pow`` and ``cos`` at most. Inputs are
made with numpy from a seed and handed to both packages. The CUDA kernel is
tested on the card by ``test_torch_llama_kernels_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.kernels.pallas.rope as JR
from paddle_tpu_torch.incubate.nn import functional as TI
from paddle_tpu_torch.kernels import rope as TR

JI = importlib.import_module("paddle_tpu.incubate.nn.functional")


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _tables(S, half, seed=1):
    ang = np.random.RandomState(seed).uniform(-3, 3, (S, half))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _t(a, dtype=torch.float32, grad=False):
    return None if a is None else torch.from_numpy(a).to(dtype) \
        .requires_grad_(grad)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


# B, S, H, D: D/2 odd (3, 5), and D 128 at GQA head counts
SHAPES = [(2, 7, 3, 6), (1, 5, 2, 10), (2, 16, 4, 128), (2, 16, 1, 128),
          (1, 33, 2, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_apply_rope_forward_and_grad_match_jax_kernel(shape):
    B, S, H, D = shape
    x, dy = _x(shape), _x(shape, seed=2)
    c, s = _tables(S, D // 2)
    xt = _t(x, grad=True)
    y = TR.apply_rope(xt, _t(c), _t(s))
    ref = JR.apply_rope(_j(x), _j(c), _j(s))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    (g,) = torch.autograd.grad(y, (xt,), _t(dy))
    rg = jax.grad(lambda a: jnp.sum(JR.apply_rope(a, _j(c), _j(s))
                                    * jnp.asarray(dy)))(_j(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-5)
    # the backward is the inverse rotation: rotating y back gives x
    back = TR.rope_plain(y.detach(), _t(c), _t(s), neg_sin=True)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)


def test_bf16_within_one_ulp_and_strided_input():
    B, S, H, D = 2, 16, 4, 128
    x = _x((B, S, H, D), seed=3)
    c, s = _tables(S, D // 2, seed=4)
    y = TR.rope(_t(x, torch.bfloat16), _t(c), _t(s))
    ref = np.asarray(JR.apply_rope(_j(x, jnp.bfloat16), _j(c), _j(s))
                     .astype(jnp.float32))
    assert y.dtype == torch.bfloat16
    ulp = np.maximum(np.abs(ref), 1e-30) * 2.0 ** -7
    assert (np.abs(y.float().numpy() - ref) <= ulp).all()
    # a strided view (q of a fused [B, S, H, 3, D] projection) rotates as
    # its contiguous copy does
    qkv = torch.from_numpy(_x((B, S, H, 3, D), seed=5))
    view = qkv[:, :, :, 0]
    assert not view.is_contiguous()
    torch.testing.assert_close(TR.rope(view, _t(c), _t(s)),
                               TR.rope(view.contiguous(), _t(c), _t(s)),
                               rtol=0, atol=0)


TABLE_FORMS = ["half", "full", "4d"]


def _table_form(c, s, form):
    if form == "half":
        return c, s
    cf, sf = (np.concatenate([t, t], -1) for t in (c, s))
    if form == "full":
        return cf, sf
    return cf[None, :, None, :], sf[None, :, None, :]


@pytest.mark.parametrize("branch", [
    "default", "half", "full", "4d", "longer_table", "position_ids",
    "interleaved", "rotate_half", "v_given", "k_none"])
def test_fused_rotary_position_embedding_matches_jax(branch):
    B, S, Hq, Hkv, D = 2, 12, 4, 2, 16
    q, k, v = (_x((B, S, h, D), seed=i) for i, h in enumerate((Hq, Hkv,
                                                               Hkv)))
    c, s = _tables(S + 5 if branch in ("longer_table", "position_ids")
                   else S, D // 2, seed=7)
    kw = {}
    if branch in TABLE_FORMS or branch in ("longer_table", "interleaved",
                                           "rotate_half", "v_given",
                                           "k_none"):
        cc, ss = _table_form(c, s, branch if branch in TABLE_FORMS
                             else "half")
        kw.update(cos=cc, sin=ss)
    if branch == "position_ids":
        cc, ss = _table_form(c, s, "full")
        kw.update(cos=cc, sin=ss, position_ids=np.random.RandomState(8)
                  .randint(0, S + 5, (B, S)))
    if branch == "interleaved":
        kw["use_neox_rotary_style"] = False
    if branch == "rotate_half":
        kw["rotate_half"] = True
    if branch != "v_given":
        v = None
    if branch == "k_none":
        k = None
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    got = TI.fused_rotary_position_embedding(_t(q), _t(k), _t(v), **tkw)
    ref = JI.fused_rotary_position_embedding(_j(q), _j(k), _j(v), **jkw)
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)


def test_fused_rope_takes_the_kernel_path_and_composes_the_rest():
    """Inside the gate the registry op is apply_rope (the kernel's plain
    version on the CPU: bit-equal); a 3-D input goes to the composed
    rotation, in both packages."""
    B, S, H, D = 2, 8, 2, 32
    q = _x((B, S, H, D), seed=9)
    c, s = _tables(S, D // 2, seed=10)
    got = TI.fused_rotary_position_embedding(_t(q), sin=_t(s), cos=_t(c))[0]
    assert torch.equal(got, TR.rope(_t(q), _t(c), _t(s)))
    q3 = _x((S, H, D), seed=11)[None]
    ref = JI._fused_rope(_j(q3), None, None, _j(c), _j(s))[0]
    got3 = TI._fused_rope(_t(q3), None, None, _t(c), _t(s))[0]
    np.testing.assert_allclose(got3.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_swiglu_fused_linear_bias_act_and_layer_norm_match_jax():
    x = _x((3, 4, 32), seed=12)
    y = _x((3, 4, 32), seed=13)
    w = _x((32, 24), seed=14)
    b = _x((24,), seed=15)
    close = lambda g, r: np.testing.assert_allclose(  # noqa: E731
        g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    close(TI.swiglu(_t(x), _t(y)), JI.swiglu(_j(x), _j(y)))
    close(TI.swiglu(_t(x)), JI.swiglu(_j(x)))
    close(TI.fused_linear(_t(x), _t(w), _t(b)),
          JI.fused_linear(_j(x), _j(w), _j(b)))
    close(TI.fused_linear(_t(x), _t(w.T.copy()), transpose_weight=True),
          JI.fused_linear(_j(x), _j(w.T.copy()), transpose_weight=True))
    bias, shift, smooth = (_x((32,), seed=i) for i in (16, 17, 18))
    for act in ("gelu", "relu", "silu", "swiglu", "geglu", "identity"):
        close(TI.fused_bias_act(_t(x), _t(bias), act_method=act),
              JI.fused_bias_act(_j(x), _j(bias), act_method=act))
    close(TI.fused_bias_act(_t(x), _t(bias), "silu", shift=_t(shift),
                            smooth=_t(smooth)),
          JI.fused_bias_act(_j(x), _j(bias), "silu", shift=_j(shift),
                            smooth=_j(smooth)))
    g, bb = _x((32,), seed=19), _x((32,), seed=20)
    close(TI.fused_layer_norm(_t(x), _t(g), _t(bb), 1e-5),
          JI.fused_layer_norm(_j(x), _j(g), _j(bb), 1e-5))
    g2 = _x((4, 32), seed=21)
    close(TI.fused_layer_norm(_t(x), _t(g2), None, 1e-5, begin_norm_axis=1),
          JI.fused_layer_norm(_j(x), _j(g2), None, 1e-5, begin_norm_axis=1))


def test_raising_arguments():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="time_major"):
        TI.fused_rotary_position_embedding(q, time_major=True)
    with pytest.raises(NotImplementedError, match="quant"):
        TI.fused_bias_act(q, dequant_scales=torch.ones(8))
    with pytest.raises(NotImplementedError, match="quant"):
        TI.fused_bias_act(q, quant_scale=1.0)
    for fn, args, item in (
            (TI.masked_multihead_attention, (q, q, q, 4), 1),
            (TI.block_multihead_attention, (q, None), 1),
            (TI.fused_attention, (q, q, q), 10),
            (TI.fused_feedforward, (q, q, q), 10)):
        with pytest.raises(NotImplementedError,
                           match=f"Queue 1 item {item}"):
            fn(*args)
    c = torch.ones(4, 4)
    with pytest.raises(ValueError, match="even D"):
        TR.rope(torch.zeros(1, 4, 2, 7), c, c)
    with pytest.raises(ValueError, match=r"\[S, D/2\]"):
        TR.rope(q, torch.ones(3, 4), torch.ones(3, 4))
