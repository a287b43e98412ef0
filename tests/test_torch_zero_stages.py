"""The port's ZeRO stages 0-3 (``paddle_tpu_torch/models/hybrid_engine.py``,
``models/gpt.py`` ``build_hybrid_train_step`` at mp = pp = 1) against the
JAX engine on the virtual CPU mesh.

The ranks run in child processes over gloo (``torch_dist_workers``: one
spawn at world 2 and one at world 4 for the whole file); the JAX goldens
come from ``G.build_hybrid_train_step`` on ``{"dp": n, "pp": 1, "mp": 1}``
over n of the virtual devices, each computed once. The model and batch are
``tests/test_zero_stages.py``'s (``CFG``: fp32, vocab 64, H 32, 4 layers;
``_data``: 8 x 16 tokens), four AdamW steps at lr 1e-2 from the JAX init.

Tolerances are that file's for zero3 against the plain step: every loss
within 2e-5 (rel and abs), the gathered final parameters within 2e-4. The
two packages add the dp sums and the GEMMs in other orders, so fp32 agrees
to ulps, not bits; inside the port, stages 1 and 2 issue the same
collectives and are held bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.comm_overlap import Zero3Config as JZero3
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.models.hybrid_engine import zero_dims as j_zero_dims
from paddle_tpu.models.hybrid_engine import (zero_param_specs as
                                             j_zero_param_specs)

import torch
import torch_dist_workers as W
from paddle_tpu_torch.distributed.comm_overlap import (CommOverlapConfig,
                                                       Zero3Config)
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import hybrid_engine as TE
from paddle_tpu_torch.models import llama as TL

CFG = JG.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
                   max_seq_len=16, dtype=jnp.float32)
LOSS_TOL = 2e-5
PARAM_TOL = 2e-4

# name -> (world, port case); the JAX golden takes the same keywords
CASES = {
    "s0": (2, dict(num_microbatches=2, zero_stage=0)),
    "s1": (2, dict(num_microbatches=2, zero_stage=1)),
    "s2": (2, dict(num_microbatches=2, zero_stage=2)),
    "s3": (2, dict(num_microbatches=2, zero_stage=3)),
    "s3_clip": (2, dict(num_microbatches=2, zero_stage=3, clip=True)),
    "s3_w4": (4, dict(num_microbatches=2, zero_stage=3)),
}
# the int8 error-feedback parameter gathers (Zero3Config(quantize=True)):
# held to the JAX engine's quantized run within its own drift budget
QUANT = {
    "s3_q": (2, dict(num_microbatches=1, zero_stage=3,
                     zero3=dict(quantize=True))),
}
PORT_ONLY = {
    "s3_no_prefetch": (2, dict(num_microbatches=2, zero_stage=3,
                               zero3=dict(overlap=False))),
    "zero1_dp": (2, dict(num_microbatches=2, zero1_dp=True)),
    "s3_m1": (2, dict(num_microbatches=1, zero_stage=3)),
    "s3_q_again": QUANT["s3_q"],
}
Q_DRIFT = 5e-2      # tests/test_zero_stages.py: quantized vs unquantized


def _data(batch=8, seq=16, vocab=64):
    rng = np.random.RandomState(0)
    return (rng.randint(0, vocab, (batch, seq)),
            rng.randint(0, vocab, (batch, seq)))


@pytest.fixture(scope="module")
def init_np():
    return jax.device_get(JG.init_hybrid_params(CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def port_runs(init_np):
    tokens, labels = _data()
    out = {}
    for world in (2, 4):
        cases = {n: c for n, (w, c) in {**CASES, **QUANT,
                                        **PORT_ONLY}.items()
                 if w == world}
        ranks = W.spawn(W.gpt_job, world, init_np, tokens, labels, cases)
        for name in cases:
            out[name] = [r[name] for r in ranks]
    return out


_JAX = {}


def _jax_run(name):
    if name not in _JAX:
        world, case = {**CASES, **QUANT}[name]
        case = dict(case)
        clip = case.pop("clip", False)
        if "zero3" in case:
            case["zero3"] = JZero3(**case["zero3"])
        mesh = jdist.build_mesh({"dp": world, "pp": 1, "mp": 1},
                                devices=jax.devices()[:world])
        opt = paddle.optimizer.AdamW(
            learning_rate=1e-2,
            grad_clip=(paddle.nn.ClipGradByGlobalNorm(0.05) if clip
                       else None),
            apply_decay_param_fun=lambda n: "ln" not in n)
        step, shard_params, init_state = JG.build_hybrid_train_step(
            CFG, mesh, opt, telemetry=None, **case)
        p = shard_params(JG.init_hybrid_params(CFG, jax.random.PRNGKey(0)))
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


def _assert_params_close(got, want, tol, what):
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_engine(port_runs, name):
    """Every step's loss and the gathered final parameters against the JAX
    engine at the same stage, world size and clip."""
    jl, jp = _jax_run(name)
    runs = port_runs[name]
    np.testing.assert_allclose(runs[0]["losses"], jl, rtol=LOSS_TOL,
                               atol=LOSS_TOL, err_msg=name)
    _assert_params_close(runs[0]["params"], jp, PARAM_TOL, name)
    # every rank holds the same trajectory and the same gathered tree
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"], name
        for (_, a), (_, b) in zip(_leaves(r["params"]),
                                  _leaves(runs[0]["params"])):
            np.testing.assert_array_equal(a, b)


def test_stages_1_and_2_are_bit_identical(port_runs):
    """Stages 1 and 2 issue the same collectives: same bits; the legacy
    ``zero1_dp=True`` is stage 1."""
    for other in ("s2", "zero1_dp"):
        assert port_runs[other][0]["losses"] == port_runs["s1"][0]["losses"]
        for (_, a), (_, b) in zip(_leaves(port_runs[other][0]["params"]),
                                  _leaves(port_runs["s1"][0]["params"])):
            np.testing.assert_array_equal(a, b)


def test_zero3_quantized_gather_tracks_jax(port_runs):
    """The int8 error-feedback block gathers: every loss within the JAX
    test's drift budget (5e-2) of the JAX engine's quantized run and of the
    port's unquantized stage 3; two runs bit for bit alike; the residuals
    ride ``state["zero3_ef"]`` shaped like the sharded block leaves, a
    0-column placeholder for the leaves with no dp dim, and carry."""
    jl, _ = _jax_run("s3_q")
    q = port_runs["s3_q"][0]
    assert np.abs(np.asarray(q["losses"]) - jl).max() < Q_DRIFT
    base = port_runs["s3_m1"][0]["losses"]
    assert np.abs(np.asarray(q["losses"]) - base).max() < Q_DRIFT
    again = port_runs["s3_q_again"][0]
    assert again["losses"] == q["losses"]
    for (_, x), (_, y) in zip(_leaves(q["params"]), _leaves(again["params"])):
        np.testing.assert_array_equal(x, y)
    assert q["zero3_ef"]["qkv_w"] == (4, 16, 96)
    assert q["zero3_ef"]["qkv_b"] == (4, 0)
    assert q["ef_abs"] > 0


def test_stage3_prefetch_changes_no_bit(port_runs):
    """Gathering block i+1 ahead of block i (the default) or on use gives
    the same bits; only the order of the transfers differs."""
    a, b = port_runs["s3"][0], port_runs["s3_no_prefetch"][0]
    assert a["losses"] == b["losses"]
    for (_, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
        np.testing.assert_array_equal(x, y)


def test_sharded_layouts_and_gather_counts(port_runs):
    """What each rank holds: stage 0 full leaves and moments; stages 1/2
    full leaves, moments 1/dp along qkv_w's dim 1; stage 3 both 1/dp. Stage
    3 gathers in groups, one collective each way a group: per step the
    once-per-step leaves (one group), and per layer and microbatch the
    ln1 / qkv group and the rest of the block, each gathered in the
    forward and again in the checkpoints' replay and reduce-scattered
    once."""
    H, L = 32, 4
    assert port_runs["s0"][0]["qkv_w_local"] == (L, H, 3 * H)
    assert port_runs["s0"][0]["moment1_local"] == (L, H, 3 * H)
    for s in ("s1", "s2"):
        assert port_runs[s][0]["qkv_w_local"] == (L, H, 3 * H)
        assert port_runs[s][0]["moment1_local"] == (L, H // 2, 3 * H)
    assert port_runs["s3"][0]["qkv_w_local"] == (L, H // 2, 3 * H)
    assert port_runs["s3"][0]["moment1_local"] == (L, H // 2, 3 * H)
    assert port_runs["s3_w4"][0]["qkv_w_local"] == (L, H // 4, 3 * H)
    uses = 1 + 2 * L * 2
    assert port_runs["s3"][0]["gathers"] == {
        "all_gather": 4 * (uses + 2 * L * 2), "reduce_scatter": 4 * uses}
    assert port_runs["s3_no_prefetch"][0]["gathers"] == \
        port_runs["s3"][0]["gathers"]


# ---------------------------------------------------------------------------
# zero_dims: the one per-leaf dp rule, the same in both packages
# ---------------------------------------------------------------------------
def _port_mesh(dims):
    return types.SimpleNamespace(shape=dict(dims), axis_names=tuple(dims))


def _spec_tuple(spec):
    return tuple(spec)


def _jax_tree_to_port(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree_to_port(v) for k, v in tree.items()}
    return tree


LLAMA = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
             num_heads=32, num_kv_heads=4, intermediate_size=5632,
             max_seq_len=2048)


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["gpt", "llama"])
def test_zero_dims_match_jax(dp, model):
    """zero_dims and zero_param_specs of the port equal the JAX engine's:
    the GPT tree under hybrid_param_specs (GPT-1.3B's shapes) and the Llama
    tree (22 layers) under replicated specs, where at dp 4 and 8 the
    stacked layer dim no longer divides and the rule falls through to a
    later dim."""
    dims = {"dp": dp, "pp": 1, "mp": 1}
    jmesh = jdist.build_mesh(dims, devices=jax.devices()[:dp])
    if model == "gpt":
        kw = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
                  num_heads=16, max_seq_len=1024)
        jex = jax.eval_shape(lambda: JG.init_hybrid_params(
            JG.GPTConfig(**kw), jax.random.PRNGKey(0)))
        jspecs = JG.hybrid_param_specs(JG.GPTConfig(**kw))
        tex = TG.init_hybrid_params(TG.GPTConfig(**kw), 0, device="meta")
        tspecs = TG.hybrid_param_specs(TG.GPTConfig(**kw))
    else:
        jex = jax.eval_shape(lambda: JL.init_hybrid_params(
            JL.LlamaConfig(**LLAMA), jax.random.PRNGKey(0)))
        jspecs = jax.tree.map(lambda _: P(), jex)
        tex = TL.init_hybrid_params(TL.LlamaConfig(**LLAMA), 0,
                                    device="meta")
        tspecs = {k: ({n: () for n in v} if isinstance(v, dict) else ())
                  for k, v in tex.items()}
    jz = j_zero_dims(jspecs, jex, jmesh, "dp")
    tz = TE.zero_dims(tspecs, tex, _port_mesh(dims), "dp")
    assert tz == _jax_tree_to_port(jz)
    jps = j_zero_param_specs(jspecs, jz, jex, "dp")
    tps = TE.zero_param_specs(tspecs, tz, tex, "dp")
    got = jax.tree.map(_spec_tuple, jps, is_leaf=lambda x: isinstance(x, P))
    assert tps == got
    if model == "llama" and dp in (4, 8):
        assert tz["blocks"]["q_w"] == 1        # 22 layers: not dim 0
    if model == "gpt":
        # strided shards: the mp-marked dims are skipped even at mp 1
        assert tz["blocks"]["proj_w"] == 2 and tz["blocks"]["qkv_b"] == -1


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def _mesh1(dims=None):
    m = _port_mesh(dims or {"dp": 1, "pp": 1, "mp": 1})
    m.rank, m.size, m.coords, m.device = 0, 1, {a: 0 for a in m.shape}, \
        torch.device("cpu")
    m.axis_index = lambda a: 0
    m.group = lambda a: None
    return m


def _opt():
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    return AdamW(learning_rate=1e-2)


def test_zero_stage_refusals():
    """``tests/test_zero_stages.py``'s refusals that apply at mp = pp = 1,
    with the port's messages."""
    cfg = W.gpt_cfg()
    mesh = _mesh1()
    with pytest.raises(Exception, match="comm_quantize"):
        TG.build_hybrid_train_step(
            cfg, mesh, _opt(), num_microbatches=2, zero_stage=2,
            comm_overlap=CommOverlapConfig(bucket_mb=1.0, quantize="int8"))
    with pytest.raises(Exception, match="zero3_quantize_ag"):
        TG.build_hybrid_train_step(
            cfg, mesh, _opt(), num_microbatches=2, zero_stage=3,
            zero3=Zero3Config(quantize=True))
    with pytest.raises(Exception, match="zero3_quantize_ag"):
        TG.build_hybrid_train_step(
            cfg, mesh, _opt(), num_microbatches=1, zero_stage=3,
            zero3=Zero3Config(quantize=True),
            comm_overlap=CommOverlapConfig(bucket_mb=1.0))
    with pytest.raises(Exception, match="legacy spelling"):
        TG.build_hybrid_train_step(cfg, mesh, _opt(), num_microbatches=2,
                                   zero1_dp=True, zero_stage=3)
    with pytest.raises(Exception, match="must be one of 0/1/2/3"):
        TG.build_hybrid_train_step(cfg, mesh, _opt(), zero_stage=4)
    with pytest.raises(Exception, match="example_params"):
        TE.build_train_step(lambda p, t, l: 0, {"w": ()}, mesh, _opt(),
                            zero_stage=1)


@pytest.mark.parametrize("kw,item", [
    (dict(fp8=True), 7), (dict(mp_overlap="seq_parallel"), 6),
    (dict(virtual_pp=2), 6), (dict(schedule="ZBH1"), 6),
    (dict(flash_attention=True), 6), (dict(numerics=True), 9),
    (dict(telemetry=object()), 9),
    # GPT-MoE is ported at ZeRO stages 0-2; its stage 3 is item 11's
    (dict(moe_cfg=True, zero_stage=3,
          mesh={"dp": 1, "ep": 1, "pp": 1, "mp": 1}), 11),
    (dict(mesh={"dp": 1, "pp": 2, "mp": 1}), 6),
    (dict(mesh={"dp": 1, "pp": 1, "mp": 2}), 6)],
    ids=["fp8", "mp_overlap", "vpp", "zbh1", "flash", "numerics",
         "telemetry", "moe", "pp2", "mp2"])
def test_later_items_raise_naming_the_item(kw, item):
    kw = dict(kw)
    mesh = _mesh1(kw.pop("mesh", None))
    cfg = W.gpt_moe_cfg() if kw.pop("moe_cfg", False) else W.gpt_cfg()
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TG.build_hybrid_train_step(cfg, mesh, _opt(), **kw)


@pytest.mark.parametrize("kw,item", [
    (dict(fp8={}), 7), (dict(telemetry=object()), 9),
    (dict(numerics=object()), 9), (dict(mp_overlap="ring"), 6),
    # the MoE plan runs at ep degree 1; its int8-EF residuals are item 6's
    (dict(moe={"ep_axis": "ep", "ef": {"init": dict}},
          mesh={"dp": 1, "ep": 1}), 6),
    (dict(flash=object()), 6),
    (dict(extra_grad_axes=("sep",), mesh={"dp": 1, "sep": 2}), 6)],
    ids=["fp8", "telemetry", "numerics", "mp_overlap", "moe", "flash",
         "extra_grad_axes"])
def test_engine_later_items_raise_naming_the_item(kw, item):
    kw = dict(kw)
    mesh = _mesh1(kw.pop("mesh", None))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TE.build_train_step(lambda p, t, l: 0, {"w": ()}, mesh, _opt(),
                            **kw)


def test_state_specs_follow_the_param_specs():
    """state_specs_for: the slots take their leaf's (dp-extended) spec, the
    step replicates, as the JAX rule does."""
    cfg = W.gpt_cfg()
    ex = TG.init_hybrid_params(cfg, 0, device="meta")
    specs = TG.hybrid_param_specs(cfg)
    zd, ss = TE.zero_state_specs(_opt(), specs, ex, _port_mesh(
        {"dp": 2, "pp": 1, "mp": 1}))
    assert ss["step"] == ()
    assert ss["slots"]["blocks"]["qkv_w"]["moment1"] == ("pp", "dp", "mp")
    assert ss["slots"]["blocks"]["qkv_b"]["moment2"] == ("pp", "mp")
    assert ss["slots"]["wte"]["moment1"] == ("mp", "dp")
    assert zd["head_w"] == 0 and zd["lnf_g"] == 0
