"""The port's parameter-streaming trainer (``paddle_tpu_torch/distributed/
sharding/param_stream.py``, GPT's and Llama's ``split_streamed_params`` /
``init_streamed_params`` / ``streamed_fns``, ``models/convert.py`` over the
segmented layout) against the JAX package's
``build_param_streamed_train_step`` on the CPU, in one process
(``device="cpu"``: "host" is plain CPU memory there).

Both packages start from the same JAX-made tree (``init_hybrid_params`` at
``PRNGKey(0)``, carried across as numpy) and train ``gpt_tiny`` /
``llama_tiny`` in fp32 for 3 AdamW steps at lr 1e-3 on a RandomState(0)
batch, with and without both clips: the loss of every step within JAX's own
2e-5 (``tests/test_offload.py``, rtol and atol), and every final parameter
leaf within 2e-5 in root-mean-square difference. Per element, Adam turns a
gradient that is all rounding noise (the key third of ``qkv_b``, which the
softmax ignores, or a weight whose terms cancel) into a step of about lr in
either package, so one element in tens of thousands may differ by more
than 2e-5 while the leaf agrees; a missed or misplaced update moves a whole
leaf by about lr (1e-3). bf16 moments with stochastic rounding are checked
inside the port only (the port does not reproduce ``jax.random``'s bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed.sharding import param_stream as JPS
from paddle_tpu.models import gpt as JG
from paddle_tpu.models import llama as JL

import torch
from paddle_tpu_torch.distributed import _tree
from paddle_tpu_torch.distributed.comm_overlap.overlap import value_and_grad
from paddle_tpu_torch.distributed.sharding import _host
from paddle_tpu_torch.distributed.sharding import param_stream as TPS
from paddle_tpu_torch.models import convert
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm, \
    ClipGradByValue
from paddle_tpu_torch.optimizer.optimizer import AdamW

TOL = dict(rtol=2e-5, atol=2e-5)
STEPS = 3
LR = 1e-3
MODELS = {
    "gpt": (JG, TG, lambda m: m.gpt_tiny, 64),
    "llama": (JL, TL, lambda m: m.llama_tiny, 32),
}
# the thresholds of tests/test_offload.py, small enough that the clip bites
CLIPS = {None: (None, None),
         "global_norm": (lambda: paddle.nn.ClipGradByGlobalNorm(0.05),
                         lambda: ClipGradByGlobalNorm(0.05)),
         "by_value": (lambda: paddle.nn.ClipGradByValue(1e-4),
                      lambda: ClipGradByValue(1e-4))}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    # many small ops: a few threads run them faster than many contending
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _job(model):
    jm, tm, preset, seq = MODELS[model]
    jcfg = preset(jm)(dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = preset(tm)(dtype=torch.float32, param_dtype=torch.float32)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, jcfg.vocab_size, (2, seq))
    labels = rng.randint(0, jcfg.vocab_size, (2, seq))
    return jm, tm, jcfg, tcfg, tokens, labels


_JAX = {}


def _jax_run(model, clip):
    key = (model, clip)
    if key not in _JAX:
        jm, _, cfg, _, tokens, labels = _job(model)
        mk = CLIPS[clip][0]
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     grad_clip=mk() if mk else None)
        place, init_state, step = JPS.build_param_streamed_train_step(
            *jm.streamed_fns(cfg), opt)
        params = jm.init_hybrid_params(cfg, jax.random.PRNGKey(0))
        hp = place(jm.split_streamed_params(params, cfg))
        hs = init_state(hp)
        losses = []
        for _ in range(STEPS):
            hp, hs, loss = step(hp, hs, jnp.asarray(tokens),
                                jnp.asarray(labels), LR)
            losses.append(float(loss))
        _JAX[key] = (losses, jax.device_get(hp))
    return _JAX[key]


def _init_np(model):
    jm, _, cfg, *_ = _job(model)
    return jax.device_get(jm.init_hybrid_params(cfg, jax.random.PRNGKey(0)))


def _port_run(model, clip, moment_dtype=None):
    _, tm, _, cfg, tokens, labels = _job(model)
    mk = CLIPS[clip][1]
    opt = AdamW(learning_rate=LR, grad_clip=mk() if mk else None,
                moment_dtype=moment_dtype)
    place, init_state, step = TPS.build_param_streamed_train_step(
        *tm.streamed_fns(cfg), opt, device="cpu")
    params = convert.params_from_jax(_init_np(model), "cpu")
    hp = place(tm.split_streamed_params(params, cfg))
    hs = init_state(hp)
    losses = []
    for _ in range(STEPS):
        hp, hs, loss = step(hp, hs, torch.from_numpy(tokens),
                            torch.from_numpy(labels), LR)
        losses.append(float(loss))
    return losses, hp, hs, step


def _assert_leaves_close(got, want):
    """Every leaf within TOL's 2e-5 in root-mean-square difference."""
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        d = g.double().numpy() - np.asarray(w, np.float64)
        rms = float(np.sqrt(np.mean(d * d))) if d.size else 0.0
        assert rms <= TOL["atol"], (k, rms, float(np.abs(d).max()))


def _segmented_leaves(tree):
    """(path, leaf) of a segmented tree, the blocks list indexed."""
    out = []
    for seg in ("embed", "head"):
        out += [((seg,) + p, t) for p, t in _tree.flatten(tree[seg])]
    for i, b in enumerate(tree["blocks"]):
        out += [(("blocks", i) + p, t) for p, t in _tree.flatten(b)]
    return out


@pytest.mark.parametrize("model,clip", [("gpt", None),
                                        ("gpt", "global_norm"),
                                        ("gpt", "by_value"),
                                        ("llama", None)])
def test_streamed_matches_jax_streamed(model, clip):
    jl, jp = _jax_run(model, clip)
    tl, tp, ts, step = _port_run(model, clip)
    np.testing.assert_allclose(tl, jl, **TOL)
    _assert_leaves_close(_segmented_leaves(tp), _segmented_leaves(jp))
    assert ts["step"] == STEPS
    # every segment lives in one flat host buffer of its own
    for seg in [tp["embed"], tp["head"], *tp["blocks"], ts["slots"]["embed"],
                *ts["slots"]["blocks"]]:
        assert isinstance(seg, _host.Segment)
    # the clip engages: the clipped run leaves the unclipped one
    if clip is not None:
        assert not np.allclose(tl, _jax_run(model, None)[0], rtol=0,
                               atol=1e-7)


def _dense_run(model, clip):
    _, tm, _, cfg, tokens, labels = _job(model)
    mk = CLIPS[clip][1]
    opt = AdamW(learning_rate=LR, grad_clip=mk() if mk else None)
    params = convert.params_from_jax(_init_np(model), "cpu")
    state = opt.init_state(params)
    t, y = torch.from_numpy(tokens), torch.from_numpy(labels)
    losses = []
    for _ in range(STEPS):
        loss, g = value_and_grad(
            lambda p: tm.dense_loss(p, t, y, cfg, remat=False), params)
        opt.apply(params, g, state, LR)
        losses.append(float(loss))
    return losses, tm.split_streamed_params(params, cfg)


@pytest.mark.parametrize("model,clip", [("gpt", None),
                                        ("gpt", "global_norm"),
                                        ("llama", "by_value")])
def test_streamed_matches_the_ports_dense_step(model, clip):
    dl, dp = _dense_run(model, clip)
    tl, tp, _, _ = _port_run(model, clip)
    np.testing.assert_allclose(tl, dl, **TOL)
    _assert_leaves_close(_segmented_leaves(tp), _segmented_leaves(dp))


@pytest.mark.parametrize("model", ["gpt", "llama"])
def test_init_streamed_params_shapes(model):
    _, tm, _, cfg, *_ = _job(model)
    got = tm.init_streamed_params(cfg, 0, device="cpu")
    ref = tm.split_streamed_params(tm.init_hybrid_params(cfg, 0, "cpu"), cfg)
    assert len(got["blocks"]) == cfg.num_layers
    sg, sr = _segmented_leaves(got), _segmented_leaves(ref)
    assert [(k, tuple(t.shape), t.dtype) for k, t in sg] == \
        [(k, tuple(t.shape), t.dtype) for k, t in sr]
    # park= sees one segment at a time, each a dict of device tensors
    seen = []
    tm.init_streamed_params(cfg, 0, park=lambda s: seen.append(sorted(s)) or s,
                            device="cpu")
    assert len(seen) == cfg.num_layers + 2
    # the same seed gives the same values; the segments differ
    again = tm.init_streamed_params(cfg, 0, device="cpu")
    for (_, a), (_, b) in zip(sg, _segmented_leaves(again)):
        assert torch.equal(a, b)


def test_convert_takes_the_segmented_tree():
    """``params_from_jax`` of JAX's segmented tree == ``split_streamed_
    params`` of the converted stacked tree."""
    _, tm, jcfg, tcfg, *_ = _job("gpt")
    stacked = _init_np("gpt")
    seg_np = jax.device_get(JG.split_streamed_params(stacked, jcfg))
    got = convert.params_from_jax(seg_np, "cpu")
    want = tm.split_streamed_params(convert.params_from_jax(stacked, "cpu"),
                                    tcfg)
    assert isinstance(got["blocks"], list)
    for (k, a), (k2, b) in zip(_segmented_leaves(got),
                               _segmented_leaves(want)):
        assert k == k2 and torch.equal(a, b)


def test_refusals_match_jax():
    _, tm, jcfg, tcfg, *_ = _job("gpt")

    class OwnApplyAdamW(AdamW):
        def apply(self, params, grads, state, lr=None):
            return super().apply(params, grads, state, lr)

    class OwnApplyAdamWJ(paddle.optimizer.AdamW):
        def apply(self, params, grads, state, lr=None):
            return super().apply(params, grads, state, lr)
    OwnApplyAdamWJ.__name__ = "OwnApplyAdamW"

    pairs = [
        (AdamW(1e-3, grad_clip=ClipGradByNorm(1.0)),
         paddle.optimizer.AdamW(1e-3, grad_clip=paddle.nn.ClipGradByNorm(
             1.0)), "ClipGradByNorm"),
        (AdamW(1e-3, apply_decay_param_fun=lambda n: "ln" not in n),
         paddle.optimizer.AdamW(1e-3, apply_decay_param_fun=lambda n: "ln"
                                not in n), "SEGMENT-relative"),
        (OwnApplyAdamW(1e-3), OwnApplyAdamWJ(1e-3), "_init_slot"),
    ]
    for mine, theirs, match in pairs:
        with pytest.raises(NotImplementedError, match=match) as a:
            TPS.build_param_streamed_train_step(*tm.streamed_fns(tcfg), mine,
                                                device="cpu")
        with pytest.raises(NotImplementedError) as b:
            JPS.build_param_streamed_train_step(*JG.streamed_fns(jcfg),
                                                theirs)
        assert str(a.value) == str(b.value)


def test_bf16_moments_sr_is_deterministic_and_per_segment():
    """Stochastic rounding of bf16 moment2 inside the port: two runs from
    one tree are bit-identical, and leaf i of a segment draws with the seed
    of leaf ``offset + i`` of the whole model, so no two leaves of the
    model (no two segments) share a seed, and their noise differs."""
    from paddle_tpu_torch.kernels.fused_adam import sr_noise

    a = _port_run("gpt", None, moment_dtype=torch.bfloat16)
    b = _port_run("gpt", None, moment_dtype=torch.bfloat16)
    assert a[0] == b[0]
    for (k, x), (_, y) in zip(_segmented_leaves(a[2]["slots"]),
                              _segmented_leaves(b[2]["slots"])):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y), k
    for (k, x), (_, y) in zip(_segmented_leaves(a[1]),
                              _segmented_leaves(b[1])):
        assert torch.equal(x, y), k

    seeds = []

    class Recording(AdamW):
        def _update_ctx(self, ctx, p, g, slot, lr, step, seed=None):
            seeds.append(seed)
            return super()._update_ctx(ctx, p, g, slot, lr, step, seed=seed)

    _, tm, _, cfg, tokens, labels = _job("gpt")
    place, init_state, step = TPS.build_param_streamed_train_step(
        *tm.streamed_fns(cfg), Recording(LR, moment_dtype=torch.bfloat16),
        device="cpu")
    hp = place(tm.split_streamed_params(
        convert.params_from_jax(_init_np("gpt"), "cpu"), cfg))
    hs = init_state(hp)
    step(hp, hs, torch.from_numpy(tokens), torch.from_numpy(labels), LR)
    n_leaves = len(_segmented_leaves(hp))
    assert sorted(seeds) == [(1, i) for i in range(n_leaves)]
    assert not torch.equal(sr_noise((64, 64), (1, 2), "cpu"),
                           sr_noise((64, 64), (1, 14), "cpu"))


def test_park_and_fetch_on_the_cpu():
    assert not TPS.supports_pinned_host("cpu")
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "d": torch.zeros((), dtype=torch.int64)}}
    host = TPS.park(tree, device="cpu")
    assert isinstance(host, _host.Segment) and not host.buffer.is_pinned()
    layout = host.layout
    assert all(off % _host.ALIGN == 0 for *_, off in layout)
    back = TPS.fetch(host, device="cpu")
    for (k, x), (_, y) in zip(_tree.flatten(back), _tree.flatten(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y), k
    # a fetch is a copy: changing it leaves the host tree as it was
    back["a"].add_(1)
    assert torch.equal(host["a"], tree["a"])
