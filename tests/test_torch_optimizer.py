"""The port's optimizer (``paddle_tpu_torch.optimizer``) against the JAX
package's (``paddle_tpu.optimizer``): ``Adam`` / ``AdamW.apply`` over a tiny
GPT parameter tree for 5 steps, and the LR schedulers.

On the CPU both packages take the composed per-leaf update (the JAX package
its XLA path, the port ``_adam_core`` + ``_store_moment``), so this holds the
update the port's small leaves take on the card, and the surrounding loop
(leaf order, decay filter, master weights, the step counter) that every
leaf goes through. Weights cross over through ``params_from_jax``, the
state through ``opt_state_from_jax``, gradients are numpy from a seed.

Tolerances: fp32 parameters and moments rtol 1e-5 (XLA and PyTorch order
and contract the same fp32 operations differently, and five steps compound
it); bf16 moments, stored round-to-nearest with the stochastic rounding off
in both packages, one bf16 ulp, and the parameters they drive rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.flags as JF
import paddle_tpu.optimizer.lr as JLR
import paddle_tpu.optimizer.optimizer as JO
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import flags as TF
from paddle_tpu_torch.models.convert import opt_state_from_jax, \
    params_from_jax
from paddle_tpu_torch.optimizer import lr as TLR
from paddle_tpu_torch.optimizer import optimizer as TO

DIMS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=64)
BF16_ULP = 2.0 ** -7


@pytest.fixture
def sr_off():
    """bf16_stochastic_rounding_moments off in both packages, restored."""
    was_j = JF.flag("bf16_stochastic_rounding_moments")
    was_t = TF.flag("bf16_stochastic_rounding_moments")
    JF.set_flags({"bf16_stochastic_rounding_moments": False})
    TF.set_flags({"bf16_stochastic_rounding_moments": False})
    yield
    JF.set_flags({"bf16_stochastic_rounding_moments": was_j})
    TF.set_flags({"bf16_stochastic_rounding_moments": was_t})


def _params(param_dtype):
    cfg = JG.GPTConfig(**DIMS, dtype=jnp.float32, param_dtype=param_dtype)
    return jax.device_get(JG.init_hybrid_params(cfg, jax.random.PRNGKey(0)))


def _grads(tree, step):
    rng = np.random.RandomState(100 + step)
    return jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.01).astype(
        np.float32), tree)


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(
        jnp.asarray(leaf).astype(jnp.float32))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_torch(v, name))
        else:
            out[name] = v.float().numpy().copy()    # not a live view
    return out


def _run(make_j, make_t, param_dtype, steps=5):
    """``steps`` applies in both packages from the same params; returns the
    per-step (JAX, port) flattened params and slots."""
    jparams = _params(param_dtype)
    jopt, topt = make_j(), make_t()
    jstate = jopt.init_state(jparams)
    tparams = params_from_jax(jparams, "cpu")
    tstate = opt_state_from_jax(jax.device_get(jstate), "cpu")
    out = []
    for s in range(steps):
        g = _grads(jparams, s)
        jparams, jstate = jopt.apply(jparams, jax.tree.map(
            lambda a, p: jnp.asarray(a).astype(p.dtype), g, jparams),
            jstate)
        tg = params_from_jax(g, "cpu")
        tg = jax.tree.map(lambda a, p: a.to(p.dtype), tg, tparams)
        same = topt.apply(tparams, tg, tstate)
        assert same[0] is tparams and same[1] is tstate     # in place
        assert tstate["step"] == int(jstate["step"]) == s + 1
        out.append((_flat(jparams), _flat_torch(tparams),
                    _flat(jstate["slots"]), _flat_torch(tstate["slots"])))
    return out


def _check(out, p_rtol, m_rtol, m_atol):
    for jp, tp, js, ts in out:
        assert set(jp) == set(tp) and set(js) == set(ts)
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=p_rtol, atol=1e-7,
                                       err_msg=k)
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=m_rtol,
                                       atol=m_atol, err_msg=k)


def _no_decay_for_biases_and_norms(name):
    leaf = name.split(".")[-1]
    return not (leaf.endswith("_b") or leaf.startswith("ln"))


FP32_CASES = {
    "adam-l2": (lambda m: m.Adam(1e-3, weight_decay=0.02)),
    "adamw": (lambda m: m.AdamW(1e-3)),
    "adamw-decay-filter": (lambda m: m.AdamW(
        1e-3, weight_decay=0.1,
        apply_decay_param_fun=_no_decay_for_biases_and_norms)),
}


@pytest.mark.parametrize("case", list(FP32_CASES))
def test_fp32_moments_match_jax(case):
    make = FP32_CASES[case]
    out = _run(lambda: make(JO), lambda: make(TO), jnp.float32)
    _check(out, 1e-5, 1e-5, 1e-9)


def test_decay_filter_reaches_every_leaf():
    """The filter decides per leaf: with a zero gradient the filtered-out
    leaves do not move and the decayed ones shrink by lr * wd."""
    jparams = _params(jnp.float32)
    tparams = params_from_jax(jparams, "cpu")
    before = _flat_torch(tparams)
    opt = TO.AdamW(1e-2, weight_decay=0.5,
                   apply_decay_param_fun=_no_decay_for_biases_and_norms)
    state = opt.init_state(tparams)
    zeros = jax.tree.map(torch.zeros_like, tparams)
    opt.apply(tparams, zeros, state)
    after = _flat_torch(tparams)
    for name, b in before.items():
        if _no_decay_for_biases_and_norms(name.replace("/", ".")):
            np.testing.assert_allclose(after[name], b * (1 - 1e-2 * 0.5),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(after[name], b)


def test_bf16_moments_match_jax(sr_off):
    mk = lambda m, dt: (lambda: m.AdamW(1e-3, moment_dtype=dt))
    out = _run(mk(JO, jnp.bfloat16), mk(TO, torch.bfloat16), jnp.float32)
    _check(out, 1e-4, BF16_ULP, 1e-9)


def test_bf16_params_with_fp32_master_match_jax():
    mk = lambda m: (lambda: m.AdamW(1e-3, multi_precision=True))
    out = _run(mk(JO), mk(TO), jnp.bfloat16)
    for jp, tp, js, ts in out:
        assert "blocks/qkv_w/master" in ts
        for k in js:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-9,
                                       err_msg=k)
        for k in jp:   # the bf16 casts of masters that agree to fp32 noise
            np.testing.assert_allclose(tp[k], jp[k], rtol=BF16_ULP,
                                       atol=1e-7, err_msg=k)


def test_state_layout_matches_jax():
    jparams = _params(jnp.bfloat16)
    jstate = JO.AdamW(1e-3, moment_dtype=jnp.bfloat16,
                      multi_precision=True).init_state(jparams)
    tstate = TO.AdamW(1e-3, moment_dtype=torch.bfloat16,
                      multi_precision=True).init_state(
        params_from_jax(jparams, "cpu"))
    assert tstate["step"] == 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jstate["slots"])[0]:
        t = tstate["slots"]
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


def test_leaf_order_and_seeds():
    """Leaves go in the JAX pytree's order (sorted keys); the stochastic
    rounding seed of leaf i at step s is (s, i), and only bf16 moments ask
    for one."""
    tparams = params_from_jax(_params(jnp.float32), "cpu")
    names = [".".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(_params(jnp.float32))[0]]
    opt = TO.AdamW(1e-3, moment_dtype=torch.bfloat16)
    state = opt.init_state(tparams)
    items = opt._leaf_items(tparams, tparams, state["slots"], 3)
    assert [n for n, _ in TO._flatten(tparams)] == names
    assert [seed for *_, seed in items] == [(3, i) for i in range(len(names))]
    fp32 = TO.AdamW(1e-3)
    assert all(seed is None for *_, seed in fp32._leaf_items(
        tparams, tparams, fp32.init_state(tparams)["slots"], 3))


# ---------------------------------------------------------------------------
# lr schedulers
# ---------------------------------------------------------------------------
SCHEDULES = {
    "linear-warmup": lambda m: m.LinearWarmup(1e-3, 5, 0.0, 1e-3),
    "cosine": lambda m: m.CosineAnnealingDecay(1e-3, T_max=12, eta_min=1e-5),
    "piecewise": lambda m: m.PiecewiseDecay([3, 8], [1e-3, 5e-4, 1e-4]),
    "warmup-then-cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-3, T_max=20), 4, 1e-5, 1e-3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedulers_match_jax(name):
    js, ts = SCHEDULES[name](JLR), SCHEDULES[name](TLR)
    jopt, topt = JO.AdamW(js), TO.AdamW(ts)
    for _ in range(25):
        assert ts() == js()
        assert topt.get_lr() == jopt.get_lr() == js()
        jopt._lr_step()
        topt._lr_step()
    with pytest.raises(RuntimeError):
        topt.set_lr(0.1)


def test_set_lr_without_scheduler():
    opt = TO.Adam(1e-3)
    opt.set_lr(5e-4)
    assert opt.get_lr() == 5e-4


# ---------------------------------------------------------------------------
# what the slice does not take
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("make,item", [
    (lambda: TO.Adam(1e-3, use_multi_tensor=True), "item 2"),
    (lambda: TO.AdamW(1e-3, use_multi_tensor=True), "item 2"),
    (lambda: TO.Adam(1e-3, lazy_mode=True), "item 2"),
    (lambda: TO.AdamW(1e-3, lr_ratio=lambda n: 1.0), "item 2"),
    (lambda: TO.AdamW(1e-3, parameters=[]), "item 10"),
    (lambda: TO.AdamW(1e-3).step(), "item 10"),
    (lambda: TO.AdamW(1e-3).clear_grad(), "item 10"),
], ids=["adam-multi-tensor", "adamw-multi-tensor", "lazy", "lr-ratio",
        "parameters", "step", "clear-grad"])
def test_unported_surface_raises(make, item):
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        make()
