"""The training slice as a whole: the port's ``dense_loss`` and its gradients
(``paddle_tpu_torch.models.gpt``) and an AdamW trajectory
(``paddle_tpu_torch.optimizer``) against the JAX package's
``jax.value_and_grad(G.dense_loss)`` and ``opt.apply``, on a tiny fp32 GPT,
and the flagship's bf16 step at its width cut to one layer.

Weights come from the JAX package's ``init_hybrid_params`` through
``params_from_jax``, the optimizer state through ``opt_state_from_jax``,
tokens and labels from numpy. On the CPU both packages run their composed
attention; the port's route on the card (the flash ``autograd.Function`` over
strided views of the head-major qkv) is held to the same JAX numbers by
running its plain versions on the CPU. Tolerances: loss and every gradient
rel 1e-5 (fp32, sums in another order), every loss of a 20-step trajectory
rel 1e-4 (the differences compound over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer.optimizer as JO
from paddle_tpu.models import gpt as JG
from paddle_tpu.observability import flops as JFL
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import opt_state_from_jax, \
    params_from_jax
from paddle_tpu_torch.observability import flops as TFL
from paddle_tpu_torch.optimizer import optimizer as TO
from test_torch_optimizer import sr_off  # noqa: F401  (the fixture)

DIMS = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
            max_seq_len=64)
B, S = 4, 64
JCFG = JG.GPTConfig(**DIMS, dtype=jnp.float32)
TCFG = TG.GPTConfig(**DIMS, dtype=torch.float32)
FLAGSHIP = dict(vocab_size=32768, hidden_size=2048, num_layers=24,
                num_heads=16, max_seq_len=1024)      # bench.py FLAGSHIP
REMAT = {"none": dict(remat=False), "full": dict(remat=True, remat_save=()),
         "selective": dict()}


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(JG.init_hybrid_params(JCFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.randint(0, DIMS["vocab_size"], (B, S)),
            rng.randint(0, DIMS["vocab_size"], (B, S)))


def _leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        name = f"{prefix}.{k}" if prefix else k
        out += (_leaves(tree[k], name) if isinstance(tree[k], dict)
                else [(name, tree[k])])
    return out


def _unflatten(pairs):
    tree = {}
    for name, v in pairs:
        *head, last = name.split(".")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def torch_loss_and_grads(params, tokens, labels, cfg, **kw):
    names, leaves = zip(*_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = TG.dense_loss(params, torch.as_tensor(tokens),
                         torch.as_tensor(labels), cfg, **kw)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return loss.detach(), _unflatten(zip(names, grads))


def jax_loss_and_grads(params, tokens, labels, cfg):
    return jax.jit(jax.value_and_grad(
        lambda p: JG.dense_loss(p, jnp.asarray(tokens), jnp.asarray(labels),
                                cfg)))(params)


def _flash_route(monkeypatch):
    """The card's attention route, through the plain versions: the flash
    autograd.Function on q, k, v views of the head-major qkv."""
    monkeypatch.setattr(TG, "_attention", lambda qkv: FA.flash_attention(
        qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2], causal=True))


def _close_rel(got, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("route", ["composed", "flash"])
def test_loss_and_every_grad_match_jax(jparams, batch, route, monkeypatch):
    if route == "flash":
        _flash_route(monkeypatch)
    jloss, jgrads = jax_loss_and_grads(jparams, *batch, JCFG)
    tloss, tgrads = torch_loss_and_grads(params_from_jax(jparams, "cpu"),
                                         *batch, TCFG)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    jflat = dict(_leaves(jax.device_get(jgrads)))
    tflat = dict(_leaves(tgrads))
    assert set(jflat) == set(tflat) and len(tflat) == 17
    for name, g in tflat.items():
        _close_rel(g, jflat[name], 1e-5, name)


def test_head_major_qkv_layout(jparams, batch):
    """qkv is [B, S, H, 3, D] (q, k, v innermost per head): the block's
    attention input equals the JAX package's reshape of the same GEMM."""
    p = {k: v[0] for k, v in params_from_jax(jparams, "cpu")["blocks"].items()}
    x = torch.from_numpy(np.random.RandomState(3).randn(B, S, 32).astype(
        np.float32))
    qkv = TG._qkv_heads(p, x, TCFG)
    ref = torch.addmm(p["qkv_b"], x.reshape(B * S, 32), p["qkv_w"]).reshape(
        B, S, 4, 3, 8)
    assert torch.equal(qkv, ref)
    _close_rel(qkv, jnp.reshape(jnp.asarray(x.numpy()) @ jnp.asarray(
        p["qkv_w"].numpy()) + jnp.asarray(p["qkv_b"].numpy()),
        (B, S, 4, 3, 8)), 1e-5, "qkv")
    assert qkv.shape == (B, S, 4, 3, 8)
    jp = {k: v[0] for k, v in jparams["blocks"].items()}
    jblock = JG.dense_block(jp, jnp.asarray(x.numpy()), JCFG)
    tblock = TG.dense_block(p, x, TCFG)
    _close_rel(tblock, jblock, 1e-5, "dense_block")


def test_adamw_trajectory_tracks_jax(jparams, batch):
    """20 AdamW steps on a repeated batch from the same params and state:
    every loss within rel 1e-4 of the JAX package's, and falling."""
    jopt = JO.AdamW(3e-3)
    jstate = jopt.init_state(jparams)
    topt = TO.AdamW(3e-3)
    tparams = params_from_jax(jparams, "cpu")
    tstate = opt_state_from_jax(jax.device_get(jstate), "cpu")
    tokens, labels = batch

    @jax.jit
    def jstep(p, s):
        loss, g = jax.value_and_grad(lambda q: JG.dense_loss(
            q, jnp.asarray(tokens), jnp.asarray(labels), JCFG))(p)
        p, s = jopt.apply(p, g, s)
        return p, s, loss

    jp, jl, tl = jparams, [], []
    for _ in range(20):
        jp, jstate, loss = jstep(jp, jstate)
        jl.append(float(loss))
        loss, grads = torch_loss_and_grads(tparams, tokens, labels, TCFG)
        topt.apply(tparams, grads, tstate)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] - 0.5
    assert tstate["step"] == 20


def test_flagship_width_bf16_adamw_tracks_jax(sr_off):
    """The flagship's step at its width (hidden 2048, 16 heads of 128) and
    its optimizer (bf16 params without a master, AdamW lr 1e-4, bf16
    moments; rounding to nearest in both packages), cut to 1 layer, vocab
    2048 and 2 x 128 tokens: 4 steps on a repeated batch from the same
    weights, every loss within rel 5e-3 of the JAX package's (bf16 rounding
    in two libraries). At this depth both trajectories fall every step."""
    dims = dict(vocab_size=2048, hidden_size=2048, num_layers=1,
                num_heads=16, max_seq_len=128)
    jcfg = JG.GPTConfig(**dims, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    tcfg = TG.GPTConfig(**dims, dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16)
    jp = jax.device_get(JG.init_hybrid_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    tokens, labels = (rng.randint(0, dims["vocab_size"], (2, 128))
                      for _ in range(2))
    jopt = JO.AdamW(learning_rate=1e-4, moment_dtype=jnp.bfloat16)
    jstate = jopt.init_state(jp)
    topt = TO.AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    tparams = params_from_jax(jp, "cpu")
    tstate = opt_state_from_jax(jax.device_get(jstate), "cpu")

    @jax.jit
    def jstep(p, s):
        loss, g = jax.value_and_grad(lambda q: JG.dense_loss(
            q, jnp.asarray(tokens), jnp.asarray(labels), jcfg))(p)
        p, s = jopt.apply(p, g, s)
        return p, s, loss

    jl, tl = [], []
    for _ in range(4):
        jp, jstate, loss = jstep(jp, jstate)
        jl.append(float(loss))
        loss, grads = torch_loss_and_grads(tparams, tokens, labels, tcfg)
        topt.apply(tparams, grads, tstate)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert all(b < a for a, b in zip(jl, jl[1:])), jl
    assert all(b < a for a, b in zip(tl, tl[1:])), tl


def test_remat_modes_are_bitwise_equal(jparams, batch):
    params = params_from_jax(jparams, "cpu")
    ref_loss, ref_grads = torch_loss_and_grads(params, *batch, TCFG,
                                               **REMAT["none"])
    for mode in ("full", "selective"):
        loss, grads = torch_loss_and_grads(params, *batch, TCFG,
                                           **REMAT[mode])
        assert torch.equal(loss, ref_loss), mode
        for (name, g), (_, r) in zip(_leaves(grads), _leaves(ref_grads)):
            assert torch.equal(g, r), (mode, name)


@pytest.mark.parametrize("mode,fwd_per_layer", [("none", 1), ("full", 2),
                                                ("selective", 1)])
def test_flash_calls_per_step_by_remat_mode(jparams, batch, monkeypatch,
                                            mode, fwd_per_layer):
    """What the ``dense_forward`` docstring states: L flash forwards per
    step without remat and under the default mode (the flash call keeps
    out and lse), 2 L under full remat, and L backward pairs in every mode;
    counted here on the calls the card would make launches of."""
    _flash_route(monkeypatch)
    calls = {"fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(FA, "flash_fwd", counted("fwd", FA.flash_fwd))
    monkeypatch.setattr(FA, "flash_bwd", counted("bwd", FA.flash_bwd))
    torch_loss_and_grads(params_from_jax(jparams, "cpu"), *batch, TCFG,
                         **REMAT[mode])
    L = DIMS["num_layers"]
    assert calls == {"fwd": fwd_per_layer * L, "bwd": L}


def _saved_activation_bytes(params, batch, mode):
    """Bytes of the distinct storages that autograd saves for the backward
    outside any checkpoint, parameters left out (a checkpoint keeps its
    inputs itself and its region's tensors are recomputed)."""
    param_ptrs = {t.untyped_storage().data_ptr() for _, t in _leaves(params)}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in param_ptrs:
            seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        torch_loss_and_grads(params, *batch, TCFG, **REMAT[mode])
    return sum(seen.values())


def test_default_remat_keeps_only_qkv_attn_out_and_lse(jparams, batch,
                                                      monkeypatch):
    """Beyond full remat, the default mode keeps per layer exactly what the
    reference's policy names, qkv and the attention output, plus the flash
    call's lse: ln1's output is recomputed with ln1, not kept for the qkv
    GEMM's weight gradient."""
    _flash_route(monkeypatch)
    params = params_from_jax(jparams, "cpu")
    extra = (_saved_activation_bytes(params, batch, "selective")
             - _saved_activation_bytes(params, batch, "full"))
    hd, nh = DIMS["hidden_size"], DIMS["num_heads"]
    per_layer = (3 * B * S * hd + B * S * hd) * 4 + B * nh * S * 4
    assert extra == DIMS["num_layers"] * per_layer


@pytest.mark.parametrize("pdt", ["float32", "bfloat16"])
def test_bf16_dtypes_land_where_jax_puts_them(batch, pdt):
    jcfg = JG.GPTConfig(**DIMS, dtype=jnp.bfloat16,
                        param_dtype=getattr(jnp, pdt))
    tcfg = TG.GPTConfig(**DIMS, dtype=torch.bfloat16,
                        param_dtype=getattr(torch, pdt))
    jp = jax.device_get(JG.init_hybrid_params(jcfg, jax.random.PRNGKey(1)))
    tp = params_from_jax(jp, "cpu")
    jlogits = JG.dense_forward(jp, jnp.asarray(batch[0]), jcfg)
    tlogits = TG.dense_forward(tp, torch.as_tensor(batch[0]), tcfg)
    assert str(tlogits.dtype).split(".")[-1] == str(jlogits.dtype)
    jloss, jgrads = jax_loss_and_grads(jp, *batch, jcfg)
    tloss, tgrads = torch_loss_and_grads(tp, *batch, tcfg)
    assert str(tloss.dtype).split(".")[-1] == str(jloss.dtype) == "float32"
    assert abs(tloss.item() - float(jloss)) <= 2e-2 * abs(float(jloss))
    for (name, g), (_, jg) in zip(_leaves(tgrads),
                                  _leaves(jax.device_get(jgrads))):
        assert str(g.dtype).split(".")[-1] == str(jg.dtype), name


def test_unported_options_raise(jparams, batch):
    params = params_from_jax(jparams, "cpu")
    tokens = torch.as_tensor(batch[0])
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TG.dense_forward(params, tokens, TCFG, fp8={})
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        TG.dense_forward(params, tokens, TCFG, flash=object())
    with pytest.raises(NotImplementedError, match="remat_save"):
        TG.dense_forward(params, tokens, TCFG, remat_save=("fc1",))


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
def test_gpt_flops_per_token_matches_jax_on_flagship(remat):
    jcfg = JG.GPTConfig(**FLAGSHIP, dtype=jnp.bfloat16,
                        param_dtype=jnp.bfloat16)
    tcfg = TG.GPTConfig(**FLAGSHIP, dtype=torch.bfloat16,
                        param_dtype=torch.bfloat16)
    jtree = jax.eval_shape(lambda: JG.init_hybrid_params(
        jcfg, jax.random.PRNGKey(0)))
    ttree = TG.init_hybrid_params(tcfg, 0, "meta")
    want = JFL.gpt_flops_per_token(jcfg, 1024, params=jtree, remat=remat)
    assert TFL.gpt_flops_per_token(tcfg, 1024, params=ttree,
                                   remat=remat) == want
    assert TFL.gpt_flops_per_token(tcfg, 1024, remat=remat) == \
        JFL.gpt_flops_per_token(jcfg, 1024, remat=remat)
    assert TFL.param_count(ttree) == JFL.param_count(jtree)


def test_peak_flops_and_mfu():
    assert TFL.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError):
        TFL.peak_flops("cpu")
    assert TFL.mfu(1000.0, 2e9, 1e12) == JFL.mfu(1000.0, 2e9, 1e12)
