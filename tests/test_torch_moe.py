"""The port's single-device MoE (``paddle_tpu_torch/incubate/distributed/
models/moe``, ``incubate/nn/functional/fused_moe.py``,
``distributed/comm_overlap/a2a.py``) against the JAX package on the CPU.

Inputs come from numpy seeds; a layer's JAX parameters are carried into the
port by name (``models/convert.py`` ``load_params``). The seeds give no
tied router probabilities: ``argmax`` takes the first maximum in both
packages, but ``torch.topk`` and ``lax.top_k`` need not order ties alike.

Tolerances are ``tests/test_moe.py``'s: the MoE layer's forward and
gradients 1e-5 rel / 1e-6 abs, ``fused_moe`` 1e-4 / 1e-5, the clip 1e-6.
Slot ids and counts are held as integers, equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models.moe import gate as JGate
from paddle_tpu.incubate.distributed.models.moe import (
    ClipGradForMOEByGlobalNorm as JClip, MoELayer as JMoE,
    clip_by_global_norm_with_moe as j_clip)
from paddle_tpu.incubate.nn.functional import fused_moe as j_fused_moe
from paddle_tpu.nn import functional_call as j_call
from paddle_tpu.nn import functional_train_graph as j_graph

import torch
from paddle_tpu_torch import device_guard
from paddle_tpu_torch import random as TR
from paddle_tpu_torch.distributed.comm_overlap import a2a as TA
from paddle_tpu_torch.incubate.distributed.models.moe import gate as TGate
from paddle_tpu_torch.incubate.distributed.models.moe import (
    BaseGate, ClipGradForMOEByGlobalNorm, GShardGate, MoELayer, NaiveGate,
    SwitchGate, TopKGate, clip_by_global_norm_with_moe, compute_capacity)
from paddle_tpu_torch.incubate.nn.functional import fused_moe
from paddle_tpu_torch.models.convert import load_params

FWD = dict(rtol=1e-5, atol=1e-6)       # tests/test_moe.py:310
FUSED = dict(rtol=1e-4, atol=1e-5)     # tests/test_moe.py:191


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the slot assignment and its two encodings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T,E,cap", [(64, 4, 20), (64, 4, 9), (37, 5, 3)],
                         ids=["roomy", "overflow", "tight"])
@pytest.mark.parametrize("prev", [False, True], ids=["first", "queued"])
def test_slot_assignment_matches_jax(T, E, cap, prev):
    """``_slot_assign``, ``_capacity_dispatch`` and
    ``_capacity_dispatch_idx`` on the same expert ids and weights: the same
    positions, kept tokens, counts and slot ids (integers, equal), the same
    combine; ``queued`` puts the choice behind earlier slots
    (``prev_counts``, GShard's second choice), where positions run past C
    and the one-hot of a position >= C must be a zero row."""
    rng = np.random.RandomState(T + E + cap)
    idx = rng.randint(0, E, T)
    w = rng.rand(T).astype(np.float32)
    pc = (rng.randint(0, cap, E).astype(np.float32) if prev else None)
    jpc = None if pc is None else jnp.asarray(pc)
    tpc = None if pc is None else _t(pc)
    jm, jpos, jkeep, jcnt = JGate._slot_assign(jnp.asarray(idx), cap, E, jpc)
    tm, tpos, tkeep, tcnt = TGate._slot_assign(_t(idx), cap, E, tpc)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    np.testing.assert_array_equal(_np(tpos), np.asarray(jpos))
    np.testing.assert_array_equal(_np(tkeep), np.asarray(jkeep))
    np.testing.assert_array_equal(_np(tcnt), np.asarray(jcnt))
    if cap < T // E:
        assert not _np(tkeep).all()       # the overflow drops tokens
    jc, jk, _ = JGate._capacity_dispatch(jnp.asarray(idx), jnp.asarray(w),
                                         cap, E, jpc)
    tc, tk, _ = TGate._capacity_dispatch(_t(idx), _t(w), cap, E, tpc)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    js, jg, jn = JGate._capacity_dispatch_idx(jnp.asarray(idx),
                                              jnp.asarray(w), cap, E, jpc)
    ts, tg, tn = TGate._capacity_dispatch_idx(_t(idx), _t(w), cap, E, tpc)
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    for tokens in (1, 7, 64, 16384):
        for k in (1, 2):
            for cf in (0.5, 1.25, 2.0, 8.0):
                assert compute_capacity(tokens, E, k, cf) == \
                    JGate.compute_capacity(tokens, E, k, cf)


def _gate_pair(name, d, e, cf, seed):
    paddle.seed(seed)
    kw = dict(capacity_factor=cf)
    jcls = {"naive": JGate.NaiveGate, "switch": JGate.SwitchGate,
            "gshard": JGate.GShardGate, "topk": JGate.TopKGate}[name]
    tcls = {"naive": NaiveGate, "switch": SwitchGate, "gshard": GShardGate,
            "topk": TopKGate}[name]
    if name in ("naive", "topk"):
        kw["top_k"] = 2
    jg = jcls(d, e, **kw)
    with device_guard("cpu"):
        tg = tcls(d, e, **kw)
    with torch.no_grad():
        tg.weight.copy_(_t(np.asarray(jg.weight.value)))
    return jg, tg


@pytest.mark.parametrize("cf", [8.0, 0.75], ids=["roomy", "overflow"])
@pytest.mark.parametrize("name", ["naive", "switch", "gshard", "topk"])
def test_gates_match_jax(name, cf):
    """Each gate on the same weight and tokens: the dense encoding's
    combine and dispatch, the index encoding's slot ids (equal) and gate
    weights, and the aux loss; the overflow case drops tokens."""
    t, d, e = 64, 16, 4
    jg, tg = _gate_pair(name, d, e, cf, 3)
    x = np.random.RandomState(1).randn(t, d).astype(np.float32)
    jc, jd, ja = jg(jnp.asarray(x))
    tc, td, ta = tg(_t(x))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **FWD)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(float(ta.detach()), float(ja), **FWD)
    js, jw, _ = jg.forward_index(jnp.asarray(x))
    ts, tw, _ = tg.forward_index(_t(x))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), **FWD)
    if cf < 1.0:
        assert (_np(ts) < 0).any()
    else:
        assert (_np(ts) >= 0).all()


def test_switch_jitter_by_its_statistics():
    """With jitter off the gate is deterministic, bit for bit across calls.
    With jitter on, every factor lies in [1 - eps, 1 + eps] with mean ~1,
    one generator seed reproduces the routing bit for bit, another seed
    changes it, and the routing is the plain gate's on the jittered
    logits (parity rule 3: the bits are torch's, not jax.random's)."""
    d, e, eps = 8, 4, 0.5
    x = _t(np.random.RandomState(2).randn(256, d).astype(np.float32))
    with device_guard("cpu"):
        plain = SwitchGate(d, e)
        jit = SwitchGate(d, e, jitter_eps=eps)
    with torch.no_grad():
        jit.weight.copy_(plain.weight)
    a, b = plain(x), plain(x)
    for u, v in zip(a, b):
        assert torch.equal(u, v)

    def run(seed):
        with TR.rng_guard(torch.Generator().manual_seed(seed)):
            return jit(x)
    r1, r2, r3 = run(5), run(5), run(6)
    for u, v in zip(r1, r2):
        assert torch.equal(u, v)
    assert not torch.equal(r1[0], r3[0])
    with TR.rng_guard(torch.Generator().manual_seed(5)):
        noise = jit._jitter((256, e), torch.device("cpu"))
    assert noise.min() >= 1 - eps and noise.max() <= 1 + eps
    with TR.rng_guard(torch.Generator().manual_seed(9)):
        big = jit._jitter((256, 256), torch.device("cpu")).double()
    # U(1 - eps, 1 + eps): mean 1, variance eps^2 / 3; within 5 sigma
    sigma = eps / math.sqrt(3.0) / 256
    assert abs(big.mean().item() - 1.0) < 5 * sigma
    assert abs(big.var().item() / (eps * eps / 3.0) - 1.0) < 0.05
    probs = torch.softmax(plain.logits(x) * noise, -1)
    combine, _, _ = TGate._capacity_dispatch(
        probs.argmax(-1), probs.amax(-1), jit.capacity(256), e)
    assert torch.equal(combine, r1[0])


# ---------------------------------------------------------------------------
# MoELayer, index and einsum
# ---------------------------------------------------------------------------
def _layer_pair(gate, mode, cf, top_k=2, d=8, f=16, e=4, seed=7):
    paddle.seed(seed)
    jl = JMoE(d, f, e, gate=gate, top_k=top_k, capacity_factor=cf,
              dispatch_mode=mode)
    with device_guard("cpu"):
        tl = MoELayer(d, f, e, gate=gate, top_k=top_k, capacity_factor=cf,
                      dispatch_mode=mode)
    params, _, buffers = j_graph(jl)
    load_params(tl, jax.device_get(params))
    return jl, params, buffers, tl


@pytest.mark.parametrize("mode", ["index", "einsum", "auto"])
@pytest.mark.parametrize("gate,cf", [("naive", 2.0), ("switch", 1.25),
                                     ("gshard", 2.0), ("switch", 0.5)],
                         ids=["naive", "switch", "gshard", "switch_drops"])
def test_moe_layer_matches_jax(gate, cf, mode):
    """Forward, aux and the gradients of sum(y^2) + aux with respect to x
    and every parameter, fp32, each dispatch form (JAX's form in the
    golden), the parameters carried by name."""
    jl, params, buffers, tl = _layer_pair(gate, mode, cf)
    x = np.random.RandomState(0).randn(64, 8).astype(np.float32)

    def jloss(p, x_):
        (y, aux), _ = j_call(jl, p, buffers, x_, return_aux=True)
        return jnp.sum(y ** 2) + aux, (y, aux)
    (jv, (jy, ja)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    xt = _t(x).requires_grad_(True)
    ty, ta = tl(xt, return_aux=True)
    loss = torch.sum(ty ** 2) + ta
    names = [n for n, _ in tl.named_parameters()]
    grads = torch.autograd.grad(loss, [xt] + list(tl.parameters()))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD)
    np.testing.assert_allclose(float(ta), float(ja), **FWD)
    assert tl.aux_loss is ta
    np.testing.assert_allclose(_np(grads[0]), np.asarray(jgx), **FWD)
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[n]), **FWD,
                                   err_msg=n)


def test_index_and_einsum_agree_on_3d_input():
    """The two encodings give the same output on a [B, S, D] input, the
    shape kept; the port's MoELayer names its parameters as the JAX one."""
    _, _, _, ti = _layer_pair("gshard", "index", 2.0)
    _, _, _, te = _layer_pair("gshard", "einsum", 2.0)
    x = _t(np.random.RandomState(4).randn(4, 16, 8).astype(np.float32))
    yi, ye = ti(x), te(x)
    assert yi.shape == (4, 16, 8)
    np.testing.assert_allclose(_np(yi), _np(ye), **FWD)
    assert [n for n, _ in ti.named_parameters()] == [
        "gate.weight", "experts.w1", "experts.b1", "experts.w2",
        "experts.b2"]


def test_legacy_forward_only_gate_falls_back_to_einsum():
    """A gate that overrides only ``forward`` has no slot ids: "auto" takes
    the dense einsum, "index" raises."""

    class Legacy(BaseGate):
        def forward(self, x):
            t = x.shape[0]
            cap = self.capacity(t)
            combine = torch.zeros((t, self.num_experts, cap))
            ar = torch.arange(t)
            combine[ar, ar % self.num_experts, ar // self.num_experts] = 1.0
            return combine, combine > 0, torch.zeros(())

    with device_guard("cpu"):
        g = Legacy(8, 4, top_k=1, capacity_factor=2.0)
        lay = MoELayer(8, 16, 4, gate=g)
        x = torch.randn(16, 8)
        assert not lay._gate_has_index
        assert lay(x).shape == (16, 8)
        lay_i = MoELayer(8, 16, 4, gate=Legacy(8, 4, top_k=1),
                         dispatch_mode="index")
        with pytest.raises(ValueError, match="index dispatch"):
            lay_i(x)


# ---------------------------------------------------------------------------
# fused_moe
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("top_k,norm", [(2, True), (1, False), (3, True)])
def test_fused_moe_matches_jax(top_k, norm):
    """``fused_moe`` forward, router probabilities and the gradients of
    sum(out^2) with respect to x and every weight; an expert that gets no
    row (E 6 over 20 tokens at top-1) is an empty group."""
    t, d, f, e = 20, 8, 16, 6
    rng = np.random.RandomState(top_k)
    args = [rng.randn(t, d), rng.randn(d, e), rng.randn(e, d, f) * 0.3,
            rng.randn(e, f) * 0.1, rng.randn(e, f, d) * 0.3,
            rng.randn(e, d) * 0.1]
    args = [a.astype(np.float32) for a in args]

    def jloss(*a):
        out, probs = j_fused_moe(*a, top_k=top_k, norm_topk_prob=norm)
        return jnp.sum(out ** 2), (out, probs)
    (_, (jo, jp)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
            *[jnp.asarray(a) for a in args])
    ts = [_t(a).requires_grad_(True) for a in args]
    to, tp = fused_moe(*ts, top_k=top_k, norm_topk_prob=norm)
    tg = torch.autograd.grad(torch.sum(to ** 2), ts)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **FUSED)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **FUSED)
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **FUSED,
                                   err_msg=f"grad {i}")


def test_fused_moe_matches_capacity_layer_when_nothing_drops():
    """Dropless grouped GEMMs equal the capacity path when no token drops
    (the JAX test's check, on the port alone), on a [B, S, D] input."""
    with device_guard("cpu"):
        lay = MoELayer(8, 16, 4, gate="naive", top_k=2, capacity_factor=8.0)
    x = torch.randn(3, 16, 8)
    out, probs = fused_moe(x, lay.gate.weight, lay.experts.w1,
                           lay.experts.b1, lay.experts.w2, lay.experts.b2,
                           top_k=2)
    assert out.shape == x.shape and probs.shape == (48, 4)
    np.testing.assert_allclose(_np(out), _np(lay(x)), **FUSED)


# ---------------------------------------------------------------------------
# the MoE clip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_moe_clip_matches_jax(clip_norm):
    """clip_by_global_norm_with_moe and the clip object on a nested tree
    (fp32 and bf16 leaves), engaged (1.0) and not (1e3): the norm and
    every clipped leaf within 1e-6."""
    rng = np.random.RandomState(0)
    tree = {"blocks": {"w1": rng.randn(2, 4, 8), "gate_w": rng.randn(4, 3)},
            "head": rng.randn(8)}
    jtree = {"blocks": {k: jnp.asarray(v, jnp.float32)
                        for k, v in tree["blocks"].items()},
             "head": jnp.asarray(tree["head"], jnp.bfloat16)}
    ttree = {"blocks": {k: _t(v.astype(np.float32))
                        for k, v in tree["blocks"].items()},
             "head": _t(tree["head"].astype(np.float32)).to(torch.bfloat16)}
    jc, jn = j_clip(jtree, clip_norm)
    tc, tn = clip_by_global_norm_with_moe(ttree, clip_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    jo = JClip(clip_norm)(jtree)
    to = ClipGradForMOEByGlobalNorm(clip_norm)(ttree)
    for k in ("w1", "gate_w"):
        for got, want in ((tc, jc), (to, jo)):
            np.testing.assert_allclose(_np(got["blocks"][k]),
                                       np.asarray(want["blocks"][k]),
                                       rtol=1e-6, atol=1e-6)
    assert tc["head"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tc["head"].float()),
                               np.asarray(jc["head"], np.float32),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# refusals: the ep exchange is item 6
# ---------------------------------------------------------------------------
def test_expert_parallel_forms_raise_naming_item_6():
    with device_guard("cpu"):
        lay = MoELayer(8, 16, 4)

        class Group2:
            nranks = 2
        with pytest.raises(NotImplementedError, match="item 6"):
            MoELayer(8, 16, 4, moe_group=Group2())
    with pytest.raises(NotImplementedError, match="item 6"):
        lay.forward_shard_map(None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="item 6"):
        lay._forward_index_ep(None)
    with pytest.raises(NotImplementedError, match="item 6"):
        clip_by_global_norm_with_moe({"w": torch.ones(2)}, 1.0, ep_axis="ep")
    with pytest.raises(NotImplementedError, match="item 6"):
        ClipGradForMOEByGlobalNorm(1.0, ep_axis="ep")
    buf = torch.randn(4, 3, 8)
    w = (torch.randn(4, 8, 16), torch.zeros(4, 16), torch.randn(4, 16, 8),
         torch.zeros(4, 8))
    for cfg in (TA.MoeDispatchConfig(quantize=True),
                TA.MoeDispatchConfig(index=True, overlap=True)):
        with pytest.raises(NotImplementedError, match="item 6"):
            TA.expert_exchange(buf, *w, ep_axis="ep", activation=torch.relu,
                               cfg=cfg)
    out, res = TA.expert_exchange(buf, *w, ep_axis="ep",
                                  activation=torch.relu)
    want = torch.bmm(torch.relu(torch.bmm(buf, w[0])), w[2])
    assert res is None
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-6, atol=1e-6)


def test_dispatch_config_resolution_matches_jax():
    """resolve_moe_dispatch and the flags: "auto" with every flag off is the
    dense baseline (None), the index flag gives index dispatch."""
    from paddle_tpu_torch.flags import set_flags
    assert TA.resolve_moe_dispatch("auto") is None
    assert TA.resolve_moe_dispatch(None) is None
    assert TA.resolve_moe_dispatch(False) is None
    assert TA.resolve_moe_dispatch(True) == TA.MoeDispatchConfig(index=True)
    set_flags({"moe_index_dispatch": True})
    try:
        assert TA.resolve_moe_dispatch("auto") == TA.MoeDispatchConfig(
            index=True)
    finally:
        set_flags({"moe_index_dispatch": False})
    with pytest.raises(ValueError):
        TA.MoeDispatchConfig(chunks=0)
