"""GPT-MoE through the port's hybrid step (``paddle_tpu_torch/models/gpt.py``
``build_hybrid_train_step`` with ``cfg.moe_num_experts``, over
``models/hybrid_engine.py``) against the JAX engine on the CPU.

The model and batch are ``tests/test_moe_hybrid.py``'s (``CFG``: fp32, vocab
64, H 32, 4 layers, 4 heads, seq 16, E 4, aux weight 1e-2; 8 x 16 tokens),
at its capacity factor 8.0 and at 1.25, where tokens drop. Both packages
start from the JAX init and take four AdamW steps at lr 1e-2 on the mesh
``{"dp": 1, "ep": 1, "pp": 1, "mp": 1}``, dense and index dispatch, one and
two microbatches; one gloo leg at world 2 (dp 2, ZeRO stage 1) against the
JAX engine at ``{"dp": 2, "ep": 1}``. The port's ranks run in child
processes (``torch_dist_workers.gpt_moe_job``: one spawn at world 1, one at
world 2).

Tolerances: every loss within 2e-5 and the final parameters within 2e-4
(``tests/test_zero_stages.py``'s, as ``test_torch_zero_stages.py``); the
port's index dispatch against its dense dispatch within
``test_moe_hybrid.py:267``'s 1e-5 / 1e-6 over six steps. The seeds give no
tied router probabilities.

Adam's epsilon is 1e-6 in both packages here (the default 1e-8 elsewhere).
Some gradient elements are pure cancellation residue: wte[20, 8]'s first
gradient is 7.45e-9 in JAX and 9.31e-9 in the port, both right to the
fp32 floor of their sums (every first-step gradient agrees within 6e-8).
At epsilon 1e-8 Adam divides such an element by |g| + 1e-8, so the two
updates differ by 0.055 lr = 5.5e-4, more than the parameter tolerance;
at 1e-6 the same residue moves the update by about 2e-5 lr.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.comm_overlap import MoeDispatchConfig as JMoeCfg
from paddle_tpu.models import gpt as JG

import torch
import torch_dist_workers as W
from paddle_tpu_torch.distributed.comm_overlap import (MoeDispatchConfig,
                                                       Zero3Config)
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.optimizer.optimizer import AdamW

LOSS_TOL = 2e-5
PARAM_TOL = 2e-4
ADAM_EPS = 1e-6

# name -> (world, case); the JAX golden takes the same case
CASES = {
    "dense_m1": (1, dict(num_microbatches=1)),
    "dense_m1_drop": (1, dict(num_microbatches=1, cf=1.25)),
    "index_m1_drop": (1, dict(num_microbatches=1, cf=1.25, index=True)),
    "dense_m2_drop": (1, dict(num_microbatches=2, cf=1.25)),
    "index_m2_drop": (1, dict(num_microbatches=2, cf=1.25, index=True)),
    "dp2_stage1_index": (2, dict(num_microbatches=1, cf=1.25, index=True,
                                 zero_stage=1)),
}
PORT_ONLY = {
    "dense_6": (1, dict(num_microbatches=1, steps=6)),
    "index_6": (1, dict(num_microbatches=1, steps=6, index=True)),
    "dense_m1_drop_s2": (1, dict(num_microbatches=1, cf=1.25,
                                 zero_stage=2)),
}


def _cfg(cf=8.0):
    return JG.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                        num_heads=4, max_seq_len=16, dtype=jnp.float32,
                        moe_num_experts=4, moe_capacity_factor=cf,
                        moe_aux_weight=1e-2)


def _data(batch=8, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 64, (batch, seq)),
            rng.randint(0, 64, (batch, seq)))


@pytest.fixture(scope="module")
def init_np():
    return jax.device_get(JG.init_hybrid_params(_cfg(),
                                                jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_runs(init_np):
    tokens, labels = _data()
    out = {}
    for world in (1, 2):
        cases = {n: c for n, (w, c) in {**CASES, **PORT_ONLY}.items()
                 if w == world}
        cases = {n: dict(c, eps=ADAM_EPS) for n, c in cases.items()}
        ranks = W.spawn(W.gpt_moe_job, world, init_np, tokens, labels,
                        cases)
        for name in cases:
            out[name] = [r[name] for r in ranks]
    return out


_JAX = {}


def _jax_run(name):
    if name not in _JAX:
        world, case = CASES[name]
        case = dict(case)
        cfg = _cfg(case.pop("cf", 8.0))
        dispatch = JMoeCfg(index=True) if case.pop("index", False) else None
        mesh = jdist.build_mesh({"dp": world, "ep": 1, "pp": 1, "mp": 1},
                                devices=jax.devices()[:world])
        step, shard_params, init_state = JG.build_hybrid_train_step(
            cfg, mesh, paddle.optimizer.AdamW(1e-2, epsilon=ADAM_EPS),
            moe_dispatch=dispatch, telemetry=None, **case)
        p = shard_params(JG.init_hybrid_params(cfg, jax.random.PRNGKey(0)))
        s = init_state(p)
        tokens, labels = (jnp.asarray(a) for a in _data())
        losses = []
        for _ in range(4):
            p, s, loss = step(p, s, tokens, labels, jnp.float32(1e-2))
            losses.append(float(loss))
        _JAX[name] = (losses, jax.device_get(p))
    return _JAX[name]


def _leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + k + ".")
        else:
            out.append((prefix + k, v))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_engine(port_runs, name):
    """Every step's loss and the final parameters (the nested pair blocks,
    the gate and the expert bank included) against the JAX engine; at
    world 2 both ranks hold the same trajectory and tree."""
    jl, jp = _jax_run(name)
    runs = port_runs[name]
    np.testing.assert_allclose(runs[0]["losses"], jl, rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg=name)
    got, want = _leaves(runs[0]["params"]), _leaves(jp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=f"{name}: {n}")
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"], name
        for (_, a), (_, b) in zip(_leaves(r["params"]), got):
            np.testing.assert_array_equal(a, b)


def test_index_dispatch_matches_dense(port_runs):
    """The port's index dispatch against its dense dispatch over six steps
    (test_moe_hybrid.py:267's 1e-5 / 1e-6); both route alike, so the drop
    record and the tokens per expert are equal."""
    a, b = port_runs["index_6"][0], port_runs["dense_6"][0]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5,
                               atol=1e-6)
    assert a["drop_frac"] == b["drop_frac"]
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_moe_record_and_zero_layouts(port_runs):
    """The last step's MOE_RECORD: at capacity factor 8 nothing drops, at
    1.25 some tokens do, and every routed token is counted (L/2 MoE layers
    x 128 tokens); two microbatches halve the capacity and drop more. The
    expert bank's first moment is whole at stages 0 and 2 at dp 1 and
    split along H (its first dim with no mesh axis) at dp 2."""
    full = port_runs["dense_m1"][0]
    assert full["drop_frac"] == 0.0
    assert full["tokens"].sum() == 2 * 128
    drop = port_runs["dense_m1_drop"][0]
    assert 0.0 < drop["drop_frac"] < 0.5
    assert port_runs["dense_m2_drop"][0]["drop_frac"] >= drop["drop_frac"]
    assert port_runs["dense_m1_drop_s2"][0]["losses"] == drop["losses"]
    assert port_runs["dense_m1_drop_s2"][0]["w1_moment1_local"] == (
        2, 4, 32, 128)
    assert port_runs["dp2_stage1_index"][0]["w1_moment1_local"] == (
        2, 4, 16, 128)


def _fake_mesh(**dims):
    return types.SimpleNamespace(shape=dict(dims), axis_names=tuple(dims))


def test_refusals_name_their_items():
    """The ep exchange's forms and an ep degree above 1 raise naming item
    6, ZeRO-3 of GPT-MoE item 11; a mesh without the ep axis, or an expert
    count the ep degree does not divide, is refused as in the JAX
    engine."""
    cfg = W.gpt_moe_cfg()
    opt = AdamW(learning_rate=1e-2)
    mesh = _fake_mesh(dp=1, ep=1, pp=1, mp=1)
    for kw in (dict(moe_dispatch=MoeDispatchConfig(quantize=True)),
               dict(moe_dispatch=MoeDispatchConfig(index=True,
                                                   overlap=True)),
               dict(moe_ef_tokens=(8, 16))):
        with pytest.raises(NotImplementedError, match="item 6"):
            TG.build_hybrid_train_step(cfg, mesh, opt, **kw)
    with pytest.raises(NotImplementedError, match="item 6"):
        TG.build_hybrid_train_step(cfg, _fake_mesh(dp=1, ep=2, pp=1, mp=1),
                                   opt)
    for kw in (dict(zero_stage=3), dict(zero_stage=3,
                                        zero3=Zero3Config(overlap=False))):
        with pytest.raises(NotImplementedError, match="item 11"):
            TG.build_hybrid_train_step(cfg, mesh, opt, **kw)
    with pytest.raises(ValueError, match="expert-parallel"):
        TG.build_hybrid_train_step(cfg, _fake_mesh(dp=1, pp=1, mp=1), opt)
    with pytest.raises(NotImplementedError, match="item 11"):
        TG.hybrid_loss_fn({}, torch.zeros((2, 4), dtype=torch.long), None,
                          cfg, 1, z3={"zdims": {}})
    with pytest.raises(ValueError, match="even"):
        TG.GPTConfig(num_layers=3, moe_num_experts=4)


def test_layout_and_specs_match_jax(init_np):
    """init_hybrid_params and hybrid_param_specs give the JAX tree's
    nesting, shapes and specs; gpt_moe_tiny and moe_telemetry_series are the
    JAX ones."""
    cfg = W.gpt_moe_cfg()
    ours = TG.init_hybrid_params(cfg, 0, device="meta")
    got = [(n, tuple(t.shape)) for n, t in _leaves(ours)]
    want = [(n, tuple(np.shape(a))) for n, a in _leaves(init_np)]
    assert got == want
    jspecs = JG.hybrid_param_specs(_cfg())
    tspecs = TG.hybrid_param_specs(cfg)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "."))
            else:
                out[prefix + k] = tuple(v)
        return out
    assert flat(tspecs) == flat(jspecs)
    tiny_t, tiny_j = TG.gpt_moe_tiny(), JG.gpt_moe_tiny()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_seq_len", "moe_num_experts", "moe_capacity_factor",
              "moe_aux_weight"):
        assert getattr(tiny_t, f) == getattr(tiny_j, f), f
    assert TG.moe_telemetry_series(cfg) == JG.moe_telemetry_series(_cfg())
    assert TG.moe_telemetry_series(W.gpt_cfg()) == ()


def test_single_device_loss_matches_jax_golden(init_np):
    """``hybrid_loss_fn(mesh=None)``, the one-device loss the card phases
    drive, on the JAX init equals the JAX engine's first loss at capacity
    factor 1.25, dense and index, with the gradients flowing to the gate
    and the expert bank."""
    from paddle_tpu_torch.models.convert import params_from_jax
    tokens, labels = (torch.from_numpy(a) for a in _data())
    cfg = W.gpt_moe_cfg(1.25)
    for name, mc in (("dense_m1_drop", None),
                     ("index_m1_drop", MoeDispatchConfig(index=True))):
        params = params_from_jax(init_np, "cpu")
        leaves = [t.requires_grad_(True) for _, t in _leaves(params)]
        loss = TG.hybrid_loss_fn(params, tokens, labels, cfg, 1, moe=mc)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(loss.item(), _jax_run(name)[0][0],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        names = [n for n, _ in _leaves(params)]
        for key in ("blocks.moe.gate_w", "blocks.moe.w1", "blocks.moe.b2"):
            g = grads[names.index(key)]
            assert torch.isfinite(g).all() and g.abs().sum() > 0, key
