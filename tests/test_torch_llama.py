"""The Llama slice as a whole: the port's ``paddle_tpu_torch.models.llama``
(the eager ``Llama`` on the port's ``nn`` layers, and the dense form
``bench_llama`` trains) against the JAX package's, on the CPU.

The eager models are built by the JAX package and carried into the port by
name (``models/convert.py`` ``load_params``); the dense trees are made by
the JAX ``init_hybrid_params`` and carried by ``params_from_jax``; inputs
come from numpy. On the CPU the port's RMSNorm takes its kernels' plain
version (fp32 arithmetic, one rounding) and attention the composed path,
where the JAX package runs its composed ops; at fp32 the two agree to
summation order. Tolerances: loss rel 1e-5; logits 2e-5; every gradient
2e-5 of its max-abs; after three AdamW steps each parameter within 1e-2 of
its update's l2 norm (Adam divides by the gradient's own scale, so an
element whose gradient is near zero turns rounding differences into steps
of up to lr; the update's norm is the scale those steps are read against).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer.optimizer as JO
import paddle_tpu.random as JR
from paddle_tpu.models import llama as JL
from paddle_tpu.nn import functional_call as j_call
from paddle_tpu.nn import functional_train_graph as j_graph
from paddle_tpu.nn.functional import cross_entropy as j_ce
from paddle_tpu.nn.functional import linear as j_linear
from paddle_tpu.observability import flops as JFL
from paddle_tpu_torch import device_guard
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.convert import load_params, params_from_jax
from paddle_tpu_torch.nn import functional_call as t_call
from paddle_tpu_torch.nn import functional_train_graph as t_graph
from paddle_tpu_torch.nn.functional import cross_entropy as t_ce
from paddle_tpu_torch.nn.functional import linear as t_linear
from paddle_tpu_torch.observability import flops as TFL
from paddle_tpu_torch.optimizer import optimizer as TO
from test_torch_optimizer import sr_off  # noqa: F401  (the fixture)

# the JAX package's test_llama.py CFG, and a width-128 GQA variant
DIMS = {
    "cfg": dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
                num_kv_heads=2, intermediate_size=48, max_seq_len=16),
    "w128": dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=256, max_seq_len=32),
}
DENSE_MAP = {"ln1_g": "input_layernorm", "q_w": "self_attn.q_proj",
             "k_w": "self_attn.k_proj", "v_w": "self_attn.v_proj",
             "o_w": "self_attn.o_proj", "ln2_g": "post_attention_layernorm",
             "gate_w": "mlp.gate_proj", "up_w": "mlp.up_proj",
             "down_w": "mlp.down_proj"}


def _cfgs(name, **kw):
    d = dict(DIMS[name], **kw)
    return (JL.LlamaConfig(**d, dtype=jnp.float32),
            TL.LlamaConfig(**d, dtype=torch.float32))


def _batch(cfg, B, S, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab_size, (B, S)),
            rng.randint(0, cfg.vocab_size, (B, S)))


@pytest.fixture(scope="module", params=sorted(DIMS))
def eager(request):
    jcfg, tcfg = _cfgs(request.param)
    with JR.rng_guard(jax.random.PRNGKey(0)):
        jmodel = JL.Llama(jcfg)
    jparams, _, jbuf = j_graph(jmodel)
    with device_guard("cpu"):
        tmodel = TL.Llama(tcfg)
    load_params(tmodel, {k: np.asarray(v)
                         for k, v in jax.device_get(jparams).items()})
    return jmodel, jparams, jbuf, tmodel, tcfg


def _jax_run(jmodel, jparams, jbuf, tokens, labels):
    def loss_fn(p):
        logits, _ = j_call(jmodel, p, jbuf, jnp.asarray(tokens))
        return j_ce(logits, jnp.asarray(labels)), logits
    (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), np.asarray(logits), jax.device_get(g)


def _torch_run(tmodel, params, tokens, labels):
    names = list(params)
    for t in params.values():
        t.requires_grad_(True)
    logits, _ = t_call(tmodel, params, {}, torch.from_numpy(tokens))
    loss = t_ce(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    for t in params.values():
        t.requires_grad_(False)
    return loss.detach(), logits.detach(), dict(zip(names, grads))


# ---------------------------------------------------------------------------
# the linear repair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x_dtype,w_dtype", [("bfloat16", "float32"),
                                             ("float32", "bfloat16")])
def test_linear_promotes_mixed_dtypes_like_jax(x_dtype, w_dtype):
    """x and W of two floating dtypes multiply in the promoted type, as
    jnp.matmul does (the eager Llama's head: an fp32 hidden state beside a
    bf16 weight; its projections: bf16 activations beside fp32 weights)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64, 48).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, x_dtype))
    jw = jnp.asarray(w).astype(getattr(jnp, w_dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    tw = torch.from_numpy(w).to(getattr(torch, w_dtype))
    for bias in (None, b):
        ref = j_linear(jx, jw, None if bias is None else jnp.asarray(bias))
        got = t_linear(tx, tw, None if bias is None
                       else torch.from_numpy(bias))
        assert ref.dtype == jnp.float32 and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# config, tables, attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("preset", ["llama_tiny", "llama2_7b", "llama2_13b",
                                    "llama3_8b"])
def test_config_presets_match_jax(preset):
    j, t = getattr(JL, preset)(), getattr(TL, preset)()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "num_kv_heads", "intermediate_size", "max_seq_len",
              "rope_theta", "rms_eps", "head_dim"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and t.param_dtype == torch.float32
    assert TFL._llama_matmul_params(t) == JFL._llama_matmul_params(j)
    assert (TFL.llama_flops_per_token(t, 1024)
            == JFL.llama_flops_per_token(j, 1024))
    with pytest.raises(Exception, match="num_kv_heads"):
        TL.LlamaConfig(hidden_size=64, num_heads=4, num_kv_heads=3)


@pytest.mark.parametrize("theta,S", [(1e4, 16), (5e5, 64)])
def test_rope_tables_and_rotation_match_jax(theta, S):
    jcfg = JL.LlamaConfig(hidden_size=128, num_heads=2, rope_theta=theta)
    tcfg = TL.LlamaConfig(hidden_size=128, num_heads=2, rope_theta=theta)
    jc, js = JL.rope_tables(jcfg, S)
    tc, ts = TL.rope_tables(tcfg, S, "cpu")
    assert tc.shape == (S, 32) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    x = np.random.RandomState(2).randn(2, S, 3, 64).astype(np.float32)
    ref = JL._rope(jnp.asarray(x), jc, js)
    got = TL._rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # position 0 is the identity; the rotation keeps the norm
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0], atol=1e-6)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)


def test_gqa_equals_mha_with_repeated_kv():
    rng = np.random.RandomState(1)
    B, S, hq, hkv, D = 2, 8, 4, 2, 6
    q, k, v = (torch.from_numpy(rng.randn(B, S, h, D).astype(np.float32))
               for h in (hq, hkv, hkv))
    out = TL._gqa_attention(q, k, v)
    ref = TL._gqa_attention(q, k.repeat_interleave(2, 2),
                            v.repeat_interleave(2, 2))
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    jout = JL._gqa_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    # the registry attention the layers call (composed on the CPU)
    torch.testing.assert_close(TL._flash_gqa(q, k, v), out, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the eager layer
# ---------------------------------------------------------------------------
def test_eager_logits_loss_and_every_grad_match_jax(eager):
    jmodel, jparams, jbuf, tmodel, tcfg = eager
    tokens, labels = _batch(tcfg, 2, 16)
    jl, jlogits, jg = _jax_run(jmodel, jparams, jbuf, tokens, labels)
    params = t_graph(tmodel, device="cpu")[0]
    assert set(params) == set(jg)
    assert sum(n.endswith("layernorm.weight") for n in params) \
        == 2 * tcfg.num_layers
    tl, tlogits, tg = _torch_run(tmodel, params, tokens, labels)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=2e-5,
                               atol=2e-5)
    for name, g in tg.items():
        ref = np.asarray(jg[name])
        err = float(np.abs(g.numpy() - ref).max()) / float(np.abs(ref).max())
        assert err <= 2e-5, (name, err)


def test_three_adamw_steps_track_jax(eager):
    jmodel, jparams, jbuf, tmodel, tcfg = eager
    tokens, labels = _batch(tcfg, 2, 16, seed=3)
    jopt, topt = JO.AdamW(1e-3), TO.AdamW(1e-3)
    jp, jstate = jparams, jopt.init_state(jparams)
    params = t_graph(tmodel, device="cpu")[0]
    init = {k: v.clone() for k, v in params.items()}
    tstate = topt.init_state(params)
    for _ in range(3):
        jl, _, jg = _jax_run(jmodel, jp, jbuf, tokens, labels)
        jp, jstate = jopt.apply(jp, jg, jstate, 1e-3)
        tl, _, tg = _torch_run(tmodel, params, tokens, labels)
        topt.apply(params, tg, tstate)
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    jp = jax.device_get(jp)
    for name, t in params.items():
        ref = np.asarray(jp[name])
        update = float(np.linalg.norm(ref - init[name].numpy()))
        diff = float(np.linalg.norm(t.numpy() - ref))
        assert diff <= 1e-2 * update, (name, diff, update)


# ---------------------------------------------------------------------------
# the dense form
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [True, False])
def test_dense_loss_and_grads_match_jax(remat):
    jcfg, tcfg = _cfgs("cfg")
    tree = jax.device_get(JL.init_hybrid_params(jcfg, jax.random.PRNGKey(0)))
    tokens, labels = _batch(tcfg, 2, 16, seed=4)
    jl, jg = jax.value_and_grad(
        lambda p: JL.dense_loss(p, jnp.asarray(tokens), jnp.asarray(labels),
                                jcfg, remat=remat))(tree)
    params = params_from_jax(tree, "cpu")
    leaves = [params["wte"], params["lnf_g"], params["head_w"],
              *params["blocks"].values()]
    for t in leaves:
        t.requires_grad_(True)
    tl = TL.dense_loss(params, torch.from_numpy(tokens),
                       torch.from_numpy(labels), tcfg, remat=remat)
    grads = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    refs = [jg["wte"], jg["lnf_g"], jg["head_w"], *jg["blocks"].values()]
    for g, r in zip(grads, refs):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max()) / float(np.abs(r).max())
        assert err <= 2e-5, err
    # the head's own loss is dense_loss's tail
    x = torch.randn(2, 16, tcfg.hidden_size)
    jx = jnp.asarray(x.numpy())
    np.testing.assert_allclose(
        TL.dense_head_loss(params, x, torch.from_numpy(labels), tcfg).item(),
        float(JL.dense_head_loss(tree, jx, jnp.asarray(labels), jcfg)),
        rtol=1e-5)


def test_eager_and_dense_forms_agree_on_mapped_weights(eager):
    """The eager layer's weights stacked into the dense tree give the same
    fp32 logits (the two forms share their math at fp32)."""
    _, _, _, tmodel, tcfg = eager
    p = t_graph(tmodel, device="cpu")[0]
    L = tcfg.num_layers
    tree = {"wte": p["embed_tokens.weight"], "lnf_g": p["norm.weight"],
            "head_w": p["lm_head.weight"],
            "blocks": {k: torch.stack([p[f"layers.{i}.{v}.weight"]
                                       for i in range(L)])
                       for k, v in DENSE_MAP.items()}}
    tokens, _ = _batch(tcfg, 2, 16, seed=5)
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        eager_logits = t_call(tmodel, p, {}, t)[0]
        dense_logits = TL.dense_forward(tree, t, tcfg, remat=False)
    torch.testing.assert_close(dense_logits, eager_logits, rtol=1e-5,
                               atol=1e-5)


def test_dense_init_keys_shapes_and_refusals():
    jcfg, tcfg = _cfgs("w128")
    jtree = jax.eval_shape(lambda: JL.init_hybrid_params(
        jcfg, jax.random.PRNGKey(0)))
    ttree = TL.init_hybrid_params(tcfg, 0, "cpu")
    again = TL.init_hybrid_params(tcfg, 0, "cpu")
    assert set(ttree) == set(jtree)
    assert set(ttree["blocks"]) == set(jtree["blocks"])
    for k in ("wte", "lnf_g", "head_w"):
        assert tuple(ttree[k].shape) == jtree[k].shape
        assert torch.equal(ttree[k], again[k])
    for k, v in ttree["blocks"].items():
        assert tuple(v.shape) == jtree["blocks"][k].shape
    assert (ttree["blocks"]["ln1_g"] == 1).all()
    # std 0.02, and std / sqrt(2L) for the residual projections
    assert abs(ttree["blocks"]["q_w"].std().item() - 0.02) < 1e-3
    assert abs(ttree["blocks"]["o_w"].std().item() - 0.01) < 1e-3
    meta = TL.init_hybrid_params(tcfg, 0, "meta")
    assert meta["wte"].device.type == "meta"
    tokens = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TL.dense_loss(ttree, tokens, tokens, tcfg, fp8={})


# ---------------------------------------------------------------------------
# bf16 at bench_llama's width
# ---------------------------------------------------------------------------
def test_llama_width_bf16_adamw_tracks_jax(sr_off):
    """bench_llama's width (hidden 2048, 16 query heads and 4 KV heads of
    128, intermediate 5632) and the card's eager step (>= 2-D parameters
    bf16, RMSNorm weights fp32, AdamW lr 1e-4 with bf16 moments; rounding
    to nearest in both packages), cut to 2 layers, vocab 2048 and one row
    of 64 tokens: 3 steps on a repeated batch from the same weights, every
    loss within rel 2e-3 of the JAX package's. The port's RMSNorm rounds
    once after the weight where the JAX composed op rounds before it, so
    the two differ by bf16 rounding from the first layer on."""
    dims = dict(vocab_size=2048, hidden_size=2048, num_layers=2,
                num_heads=16, num_kv_heads=4, intermediate_size=5632,
                max_seq_len=64, rms_eps=1e-5)
    jcfg = JL.LlamaConfig(**dims, dtype=jnp.bfloat16)
    tcfg = TL.LlamaConfig(**dims, dtype=torch.bfloat16)
    with JR.rng_guard(jax.random.PRNGKey(0)):
        jmodel = JL.Llama(jcfg)
    jp, _, jbuf = j_graph(jmodel)
    with device_guard("cpu"):
        tmodel = TL.Llama(tcfg)
    load_params(tmodel, {k: np.asarray(v)
                         for k, v in jax.device_get(jp).items()})
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2
                      else x, jp)
    tp = {k: v.to(torch.bfloat16) if v.dim() >= 2 else v
          for k, v in t_graph(tmodel, device="cpu")[0].items()}
    assert sum(v.dtype == torch.float32 for v in tp.values()) == 5
    tokens, labels = _batch(tcfg, 1, 64, seed=6)
    jopt = JO.AdamW(1e-4, moment_dtype=jnp.bfloat16)
    topt = TO.AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    jstate, tstate = jopt.init_state(jp), topt.init_state(tp)

    @jax.jit
    def jstep(p, s):
        def loss_fn(q):
            logits, _ = j_call(jmodel, q, jbuf, jnp.asarray(tokens))
            return j_ce(logits, jnp.asarray(labels))
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, s = jopt.apply(p, g, s, 1e-4)
        return p, s, loss

    jl, tl = [], []
    for _ in range(3):
        jp, jstate, loss = jstep(jp, jstate)
        jl.append(float(loss))
        loss, logits, grads = _torch_run(tmodel, tp, tokens, labels)
        assert logits.dtype == torch.float32
        topt.apply(tp, grads, tstate)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    for losses in (jl, tl):
        assert losses[2] < losses[0], losses
