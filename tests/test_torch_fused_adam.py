"""The port's one-pass Adam update (``paddle_tpu_torch.kernels.fused_adam``)
against the JAX package's Pallas kernel (``kernels/pallas/fused_adam.py``),
run in interpret mode on the CPU, and the port's stochastic rounding against
the JAX package's ``optimizer._sr_to_bf16``.

On the CPU the wrapper ``adam_update`` takes the kernel's plain PyTorch
version, the one ``chip_smoke.py`` holds the CUDA kernel to on the card.
Inputs are made with numpy from a seed and handed to both packages. With the
stochastic rounding off the update is deterministic: fp32 outputs agree to
the tolerances of ``test_fused_adam.py`` (params rtol 1e-6, moment1 1e-5,
moment2 1e-4: fma contraction and operation order differ between XLA and
PyTorch), and bf16 outputs to one bf16 ulp (those fp32 differences may move a
value across a rounding boundary) with the same absolute floor for values
that cancel to near zero. The CUDA kernel itself is tested on the
card by ``test_torch_train_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer.optimizer as JO
from paddle_tpu.kernels.pallas import fused_adam as JFA
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch.kernels import fused_adam as FAD
from paddle_tpu_torch.models import gpt as TG

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
BF16_ULP = 2.0 ** -7            # bf16 spacing relative to the value
FLAGSHIP = dict(vocab_size=32768, hidden_size=2048, num_layers=24,
                num_heads=16, max_seq_len=1024)      # bench.py FLAGSHIP
ADAM = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)


def _case(shape, pdt, mdt, master, seed=0):
    """numpy p, g, moment1, moment2 (non-negative) and an optional fp32
    master a little off p, rounded to their storage dtypes through torch."""
    rng = np.random.RandomState(seed)

    def arr(scale, dt):
        x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
        return x.to(TDT[dt]).float().numpy()
    out = {"p": arr(1.0, pdt), "g": arr(0.01, pdt),
           "moment1": arr(0.01, mdt), "moment2": np.abs(arr(1e-4, mdt))}
    if master:
        out["master"] = out["p"] + np.float32(1e-4)
    return out


def _jax_update(c, pdt, mdt, step, l2, dec):
    j = lambda k, dt: jnp.asarray(c[k]).astype(JDT[dt])
    slot = {"moment1": j("moment1", mdt), "moment2": j("moment2", mdt)}
    if "master" in c:
        slot["master"] = jnp.asarray(c["master"])
    p, s = JFA.adam_update(j("p", pdt), j("g", pdt), slot, 1e-3,
                           jnp.asarray(step, jnp.int32), None, l2=l2,
                           decoupled=dec, **ADAM)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return f32(p), {k: f32(v) for k, v in s.items()}


def _torch_update(c, pdt, mdt, step, l2, dec):
    t = lambda k, dt: torch.from_numpy(c[k]).to(TDT[dt])
    p = t("p", pdt)
    slot = {"moment1": t("moment1", mdt), "moment2": t("moment2", mdt)}
    if "master" in c:
        slot["master"] = torch.from_numpy(c["master"].copy())
    n = FAD.adam_update.LAUNCHES
    p2, s2 = FAD.adam_update(p, t("g", pdt), slot, 1e-3, step, None, l2=l2,
                             decoupled=dec, **ADAM)
    assert FAD.adam_update.LAUNCHES == n          # the CPU path launches none
    assert p2 is p and s2 is slot                 # updated in place
    assert p.dtype == TDT[pdt] and slot["moment2"].dtype == TDT[mdt]
    return p.float().numpy(), {k: v.float().numpy() for k, v in slot.items()}


def _close(got, ref, dt, rtol, atol, what):
    if dt == "bf16":
        rtol = BF16_ULP
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("pdt,mdt,master", [
    ("fp32", "fp32", False), ("bf16", "bf16", False),
    ("bf16", "bf16", True), ("bf16", "fp32", True)],
    ids=["fp32", "bf16", "bf16-master", "bf16-fp32moments-master"])
@pytest.mark.parametrize("shape", [(256, 256), (8, 3, 300)])
@pytest.mark.parametrize("l2,dec", [(0.02, 0.0), (0.0, 0.01)],
                         ids=["adam-l2", "adamw-decoupled"])
def test_plain_matches_jax_kernel(pdt, mdt, master, shape, l2, dec):
    c = _case(shape, pdt, mdt, master)
    ref_p, ref_s = _jax_update(c, pdt, mdt, 3, l2, dec)
    got_p, got_s = _torch_update(c, pdt, mdt, 3, l2, dec)
    _close(got_p, ref_p, pdt, 1e-6, 1e-7, "p")
    _close(got_s["moment1"], ref_s["moment1"], mdt, 1e-5, 1e-8, "moment1")
    _close(got_s["moment2"], ref_s["moment2"], mdt, 1e-4, 1e-9, "moment2")
    if master:
        np.testing.assert_allclose(got_s["master"], ref_s["master"],
                                   rtol=1e-6, atol=1e-7)
        # the update started from the master, not from the bf16 p
        assert not np.array_equal(got_s["master"], c["p"])


def test_bias_corrections_are_float32():
    """1 - beta**step in float32, as the JAX package computes it."""
    for step in (1, 7, 1000):
        c1, c2 = FAD.bias_corrections(0.9, 0.999, step)
        s = jnp.float32(step)
        assert c1 == float(1.0 - jnp.float32(0.9) ** s)
        assert c2 == float(1.0 - jnp.float32(0.999) ** s)


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------
def test_sr_to_bf16_bitwise_matches_jax():
    """Given JAX's own noise bits, the port's rounding is JAX's, bit for
    bit: magnitudes across the range, both signs, exact bf16 values."""
    rng = np.random.RandomState(4)
    x = (rng.randn(64, 257) * np.exp(rng.uniform(-20, 20, (64, 257)))
         ).astype(np.float32)
    x[0, :8] = [0.0, -0.0, 1.0, -2.5, 3.0e38, -3.0e38, 1e-40, 65536.0]
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JO._sr_to_bf16(jnp.asarray(x), key).view(jnp.uint16))
    noise = np.asarray(jax.random.bits(key, x.shape, jnp.uint32)
                       & jnp.uint32(0xFFFF)).astype(np.int64)
    got = FAD.sr_to_bf16(torch.from_numpy(x), torch.from_numpy(noise))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(
        np.uint16), ref)


def test_sr_is_unbiased():
    """A value 0.3 of the way between two bf16 neighbours: every draw lands
    on one of them, and over 2^20 draws the mean is the value within 5
    standard errors (0.0023 ulp)."""
    lo = 1.0 + 37 * BF16_ULP
    x = torch.full((1 << 20,), lo + 0.3 * BF16_ULP, dtype=torch.float32)
    noise = FAD.sr_noise(x.shape, (11, 3), "cpu")
    r = FAD.sr_to_bf16(x, noise).float()
    assert bool(((r == lo) | (r == lo + BF16_ULP)).all())
    bias = (r.double().mean().item() - x[0].item()) / BF16_ULP
    assert abs(bias) < 5 * np.sqrt(0.3 * 0.7 / x.numel()), bias
    # the same seed gives the same draw; another seed another
    assert torch.equal(noise, FAD.sr_noise(x.shape, (11, 3), "cpu"))
    assert not torch.equal(noise, FAD.sr_noise(x.shape, (11, 4), "cpu"))


def test_wrapper_rounds_moment2_stochastically_with_a_seed():
    """On the CPU the wrapper's seed turns on the plain version's SR of a
    bf16 moment2: each value is a bf16 neighbour of the fp32 update."""
    c = _case((256, 256), "bf16", "bf16", False, seed=5)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    exact = {"moment1": t["moment1"].clone(), "moment2": t["moment2"].clone()}
    FAD.adam_update_plain(t["p"].clone(), t["g"], exact, 1e-3, 2, None,
                          decoupled=0.01, **ADAM)
    slot = {"moment1": t["moment1"].bfloat16(),
            "moment2": t["moment2"].bfloat16()}
    FAD.adam_update(t["p"].bfloat16(), t["g"].bfloat16(), slot, 1e-3, 2,
                    (2, 0), decoupled=0.01, **ADAM)
    x, m2 = exact["moment2"], slot["moment2"].float()
    lo = (x.view(torch.int32) & -65536).view(torch.float32)
    hi = (lo.view(torch.int32) + 65536).view(torch.float32)
    assert bool(((m2 == lo) | (m2 == hi)).all())
    assert bool((m2 == hi).any()) and bool((m2 == lo).any())


# ---------------------------------------------------------------------------
# the shape gate
# ---------------------------------------------------------------------------
def test_supported_agrees_with_jax_on_flagship_leaves():
    """JAX's gate on the flagship's abstract leaves (ShapeDtypeStruct) and
    the port's on meta tensors: the same answer for every leaf, and exactly
    9 of the 17 leaves take the fused kernel."""
    jcfg = JG.GPTConfig(**FLAGSHIP, dtype=jnp.bfloat16,
                        param_dtype=jnp.bfloat16)
    jtree = jax.eval_shape(lambda: JG.init_hybrid_params(
        jcfg, jax.random.PRNGKey(0)))
    ttree = TG.init_hybrid_params(TG.GPTConfig(
        **FLAGSHIP, dtype=torch.bfloat16, param_dtype=torch.bfloat16), 0,
        "meta")
    eligible = []
    for path, sds in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        names = [k.key for k in path]
        t = ttree
        for k in names:
            t = t[k]
        assert tuple(t.shape) == sds.shape and t.device.type == "meta"
        want = JFA.supported(sds, sds, {"moment1": sds, "moment2": sds})
        got = FAD.supported(t, t, {"moment1": t, "moment2": t})
        assert got == want, names
        if got:
            eligible.append(names[-1])
    assert sorted(eligible) == sorted(
        ["wte", "wpe", "head_w", "qkv_w", "qkv_b", "proj_w", "fc1_w",
         "fc1_b", "fc2_w"])
    assert len(jax.tree.leaves(jtree)) == 17


@pytest.mark.parametrize("shape,ok", [((256, 256), True), ((65536,), False),
                                      ((255, 256), False), ((2, 32768), True)])
def test_supported_by_shape(shape, ok):
    t = torch.empty(shape, device="meta")
    slot = {"moment1": t, "moment2": t}
    assert FAD.supported(t, t, slot) is ok
    assert FAD.supported(t, None, slot) is False
    assert FAD.supported(t, t, {"moment1": t}) is False
    assert FAD.supported(t, t, dict(slot, master=t.bfloat16())) is False
