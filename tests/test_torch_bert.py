"""The BERT slice as a whole: the port's ``BertForPretraining``
(``paddle_tpu_torch.models.bert``, on the port's ``nn`` layers) against the
JAX package's, at fp32 on the CPU.

A tiny BERT (2 layers, hidden 128, 2 heads of 64, FFN 256, vocab 512,
dropout 0) is built by the JAX package; its ``functional_train_graph`` tree
goes into the port's model by name (``models/convert.py`` ``load_params``),
inputs come from numpy. Held: the forward logits for unpacked rows, a 2-D
padding mask, packed rows and ``bench_bert_base``'s 4-D bool mask;
``bert_pretrain_loss`` and the gradient of every parameter; three AdamW
steps; ``pack_sequences``; and that packed rows give the unpacked
encodings. On the CPU the port's LayerNorm and attention
take their kernels' plain versions, or the composed path the registry sends
CPU tensors to. Tolerances: fp32 sums in another order, rel 1e-5 on the loss,
2e-5 on logits and encodings, 1e-4 of each gradient's max-abs; after three
AdamW steps each parameter's difference within 1e-2 of its update's l2 norm
(Adam divides by the gradient's own scale, so an element whose gradient is
near zero turns the packages' different rounding into steps that differ by
up to lr; the update's norm is the scale those steps are read against). The
key projection's bias has a gradient of exactly zero (it adds one constant
to every score of a softmax row), so both packages return rounding noise
there: it is held below 1e-6 of the model's largest gradient in each, and
Adam, which turns noise into steps of about lr, is held to move it by at
most 1.5 lr a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer.optimizer as JO
import paddle_tpu.random as JR
from paddle_tpu.models import bert as JB
from paddle_tpu.nn import functional_call as j_call
from paddle_tpu.nn import functional_train_graph as j_graph
from paddle_tpu.nn.functional import cross_entropy as j_ce
from paddle_tpu_torch import device_guard
from paddle_tpu_torch.models import bert as TB
from paddle_tpu_torch.models.convert import load_params
from paddle_tpu_torch.nn import functional_call as t_call
from paddle_tpu_torch.nn import functional_train_graph as t_graph
from paddle_tpu_torch.nn.functional import cross_entropy as t_ce
from paddle_tpu_torch.optimizer import optimizer as TO
from test_torch_optimizer import sr_off  # noqa: F401  (the fixture)

DIMS = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position_embeddings=64,
            hidden_dropout=0.0)
S = 64
ZERO_GRAD = "self_attn.k_proj.bias"


@pytest.fixture(scope="module")
def models():
    jmodel = JB.BertForPretraining(JB.BertConfig(**DIMS))
    jparams, _, jbuf = j_graph(jmodel)
    flat = {k: np.asarray(v) for k, v in jax.device_get(jparams).items()}
    with device_guard("cpu"):
        tmodel = TB.BertForPretraining(TB.BertConfig(**DIMS))
    load_params(tmodel, flat)
    return jmodel, jparams, jbuf, tmodel


def _corpus(seed=0):
    rng = np.random.RandomState(seed)
    lens = [40, 17, 64, 25, 33, 9]
    return [rng.randint(1, DIMS["vocab_size"], (n,)) for n in lens]


def _inputs(kind, seed=0):
    """(input kwargs as numpy, mlm labels, nsp labels) for one layout."""
    rng = np.random.RandomState(seed + 1)
    seqs = _corpus(seed)
    if kind == "packed":
        ids, seg, pos, _, _ = TB.pack_sequences(seqs, S)
        kw = dict(pack_segment_ids=seg, position_ids=pos)
        real = seg >= 0
    else:
        ids = np.zeros((len(seqs), S), np.int32)
        mask = np.zeros((len(seqs), S), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        kw = dict(attention_mask=mask) if kind == "mask" else {}
        real = mask > 0
        if kind == "mask4d":          # bench_bert_base's [B, 1, S, S] mask
            kw = dict(attention_mask=real[:, None, None, :]
                      & real[:, None, :, None])
    B = ids.shape[0]
    mlm = np.where((rng.rand(B, S) < 0.3) & real,
                   rng.randint(0, DIMS["vocab_size"], (B, S)), -100)
    nsp = rng.randint(0, 2, (B,))
    return ids, kw, mlm, nsp


def _jax_run(jmodel, jparams, jbuf, ids, kw, mlm, nsp):
    def loss_fn(p):
        (lm, ns), _ = j_call(jmodel, p, jbuf, jnp.asarray(ids),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        return JB.bert_pretrain_loss(lm, ns, jnp.asarray(mlm),
                                     jnp.asarray(nsp)), (lm, ns)
    (loss, (lm, ns)), g = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    return float(loss), np.asarray(lm), np.asarray(ns), jax.device_get(g)


def _torch_run(tmodel, params, ids, kw, mlm, nsp):
    for t in params.values():
        t.requires_grad_(True)
    (lm, ns), _ = t_call(tmodel, params, {}, torch.from_numpy(ids),
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    loss = TB.bert_pretrain_loss(lm, ns, torch.from_numpy(mlm),
                                 torch.from_numpy(nsp))
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    for t in params.values():
        t.requires_grad_(False)
    return loss.detach(), lm.detach(), ns.detach(), dict(zip(names, grads))


def _cpu_params(tmodel):
    return t_graph(tmodel, device="cpu")[0]


@pytest.mark.parametrize("kind", ["unpacked", "mask", "packed", "mask4d"])
def test_logits_loss_and_every_grad_match_jax(models, kind):
    jmodel, jparams, jbuf, tmodel = models
    ids, kw, mlm, nsp = _inputs(kind)
    jl, jlm, jns, jg = _jax_run(jmodel, jparams, jbuf, ids, kw, mlm, nsp)
    params = _cpu_params(tmodel)
    assert set(params) == set(jg)
    tl, tlm, tns, tg = _torch_run(tmodel, params, ids, kw, mlm, nsp)
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    # logits at the positions the loss reads: a pad query's row differs by
    # design under the rewrite of a 2-D mask (it sees only pads)
    real = ids != 0
    np.testing.assert_allclose(tlm.numpy()[real], jlm[real], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tns.numpy(), jns, rtol=2e-5, atol=2e-5)
    gmax = max(float(np.abs(np.asarray(r)).max()) for r in jg.values())
    for name, g in tg.items():
        ref = np.asarray(jg[name])
        if name.endswith(ZERO_GRAD):
            assert max(float(g.abs().max()), float(np.abs(ref).max())) \
                <= 1e-6 * gmax, name
            continue
        err = float(np.abs(g.numpy() - ref).max()) / float(np.abs(ref).max())
        assert err <= 1e-4, (name, err)


def test_three_adamw_steps_track_jax(models):
    jmodel, jparams, jbuf, tmodel = models
    ids, kw, mlm, nsp = _inputs("packed", seed=3)
    jopt, topt = JO.AdamW(1e-3), TO.AdamW(1e-3)
    jp, jstate = jparams, jopt.init_state(jparams)
    params = _cpu_params(tmodel)
    init = {k: v.clone() for k, v in params.items()}
    tstate = topt.init_state(params)
    for _ in range(3):
        jl, _, _, jg = _jax_run(jmodel, jp, jbuf, ids, kw, mlm, nsp)
        jp, jstate = jopt.apply(jp, jg, jstate, 1e-3)
        tl, _, _, tg = _torch_run(tmodel, params, ids, kw, mlm, nsp)
        topt.apply(params, tg, tstate)
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
    assert tstate["step"] == 3
    jp = jax.device_get(jp)
    for name, t in params.items():
        ref = np.asarray(jp[name])
        if name.endswith(ZERO_GRAD):
            for moved in (t.numpy() - init[name].numpy(),
                          ref - init[name].numpy()):
                assert float(np.abs(moved).max()) <= 3 * 1.5e-3
            continue
        update = float(np.linalg.norm(ref - init[name].numpy()))
        diff = float(np.linalg.norm(t.numpy() - ref))
        assert diff <= 1e-2 * update, (name, diff, update)


def test_bert_base_width_bf16_adamw_tracks_jax(sr_off):
    """BERT-base's width (hidden 768, 12 heads of 64, FFN 3072) and its
    bench's optimizer (bf16 >= 2-D parameters, AdamW lr 1e-4 with bf16
    moments; rounding to nearest in both packages), cut to 2 layers, vocab
    2048 and 5 packed rows of 128 from the bench's length generator: 6
    steps on a repeated batch from the same weights, every loss within rel
    5e-3 of the JAX package's. Both rise after the first step, as the
    full-width step on the card does (the first AdamW update moves every
    weight by lr), and fall after it."""
    dims = dict(vocab_size=2048, hidden_size=768, num_layers=2, num_heads=12,
                intermediate_size=3072, max_position_embeddings=128,
                hidden_dropout=0.0)
    with JR.rng_guard(jax.random.PRNGKey(0)):
        jmodel = JB.BertForPretraining(JB.BertConfig(**dims))
    jp, _, jbuf = j_graph(jmodel)
    with device_guard("cpu"):
        tmodel = TB.BertForPretraining(TB.BertConfig(**dims))
    load_params(tmodel, {k: np.asarray(v)
                         for k, v in jax.device_get(jp).items()})
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2
                      else x, jp)
    tp = {k: v.to(torch.bfloat16) if v.dim() >= 2 else v
          for k, v in _cpu_params(tmodel).items()}
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, 2048, (n,)) for n in rng.randint(16, 129, (6,))]
    ids, seg, pos, _, _ = TB.pack_sequences(seqs, 128)
    rows = ids.shape[0]
    mlm = np.where((rng.rand(rows, 128) < 0.15) & (seg >= 0),
                   rng.randint(0, 2048, (rows, 128)), -100)
    nsp = rng.randint(0, 2, (rows,))
    kw = dict(pack_segment_ids=seg, position_ids=pos)
    jopt = JO.AdamW(1e-4, moment_dtype=jnp.bfloat16)
    topt = TO.AdamW(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    jstate, tstate = jopt.init_state(jp), topt.init_state(tp)

    @jax.jit
    def jstep(p, s):
        def loss_fn(q):
            (lm, ns), _ = j_call(jmodel, q, jbuf, jnp.asarray(ids),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
            return JB.bert_pretrain_loss(lm, ns, jnp.asarray(mlm),
                                         jnp.asarray(nsp))
        loss, g = jax.value_and_grad(loss_fn)(p)
        p, s = jopt.apply(p, g, s, 1e-4)
        return p, s, loss

    jl, tl = [], []
    for _ in range(6):
        jp, jstate, loss = jstep(jp, jstate)
        jl.append(float(loss))
        loss, _, _, grads = _torch_run(tmodel, tp, ids, kw, mlm, nsp)
        topt.apply(tp, grads, tstate)
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    for losses in (jl, tl):
        assert losses[1] > losses[0], losses
        assert all(b < a for a, b in zip(losses[1:], losses[2:])), losses


def test_pack_sequences_matches_jax():
    seqs = [np.arange(1, n + 1) for n in (6, 5, 3, 8, 1, 7)]
    for got, ref in zip(TB.pack_sequences(seqs, 8, pad_id=0),
                        JB.pack_sequences(seqs, 8, pad_id=0)):
        if isinstance(ref, np.ndarray):
            assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    big = _corpus()
    for got, ref in zip(TB.pack_sequences(big, S), JB.pack_sequences(big, S)):
        np.testing.assert_array_equal(got, ref)


def test_packed_matches_unpacked():
    """Two sequences packed into one row (segment ids, restarting
    positions) encode as each does alone in its own padded row (the JAX
    package's ``test_bert_packed_matches_unpacked``)."""
    cfg = TB.BertConfig(vocab_size=97, hidden_size=32, num_layers=2,
                        num_heads=4, intermediate_size=64,
                        max_position_embeddings=16, hidden_dropout=0.0)
    with device_guard("cpu"):
        model = TB.BertModel(cfg).eval()
    rng = np.random.RandomState(0)
    seq_a, seq_b = rng.randint(0, 97, (9,)), rng.randint(0, 97, (5,))
    ids, seg, pos, row_of, off_of = TB.pack_sequences([seq_a, seq_b], 16)
    assert ids.shape == (1, 16) and row_of == [0, 0] and off_of == [0, 9]
    with torch.no_grad():
        packed, _ = model(torch.from_numpy(ids),
                          pack_segment_ids=torch.from_numpy(seg),
                          position_ids=torch.from_numpy(pos))
        for s, off in ((seq_a, 0), (seq_b, 9)):
            L = len(s)
            solo_ids = np.zeros((1, 16), np.int32)
            solo_ids[0, :L] = s
            mask = np.zeros((1, 16), np.int64)
            mask[0, :L] = 1
            solo, _ = model(torch.from_numpy(solo_ids),
                            attention_mask=torch.from_numpy(mask))
            np.testing.assert_allclose(packed[0, off:off + L].numpy(),
                                       solo[0, :L].numpy(), atol=2e-5,
                                       rtol=1e-5)


def test_layers_live_on_the_resolved_device():
    """A layer's parameters go where ``device=None`` resolves: the card, or
    the device of the enclosing ``device_guard``; without a card and
    without a guard, building one raises (no silent CPU run). A layer built
    under the guard holds the values the same seed draws for the card."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.random import rng_guard
    with device_guard("cpu"), rng_guard(torch.Generator().manual_seed(3)):
        lin = Linear(8, 4)
    assert {p.device.type for p in lin.parameters()} == {"cpu"}
    if torch.cuda.is_available():
        with rng_guard(torch.Generator().manual_seed(3)):
            card = Linear(8, 4)
        assert card.weight.device.type == "cuda"
        assert torch.equal(card.weight.cpu(), lin.weight)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Linear(8, 4)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.RandomState(4)
    logits = rng.randn(3, 7, 11).astype(np.float32) * 3
    labels = rng.randint(0, 11, (3, 7))
    labels[0, :4] = -100
    got = t_ce(torch.from_numpy(logits), torch.from_numpy(labels),
               ignore_index=-100, reduction=reduction)
    ref = j_ce(jnp.asarray(logits), jnp.asarray(labels), ignore_index=-100,
               reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_parameter_names_dtypes_and_load_params_refusals(models):
    """The port's layers carry the JAX names (77 of the >= 2-D leaves at
    BERT-base's shapes take the fused Adam kernel's gate); load_params
    refuses a missing name, an extra one and a shape that differs."""
    _, jparams, _, tmodel = models
    names = [n for n, _ in tmodel.named_parameters()]
    assert names[:2] == ["bert.embeddings.word_embeddings.weight",
                         "bert.embeddings.position_embeddings.weight"]
    assert "bert.encoder.layers.1.self_attn.q_proj.weight" in names
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    flat = {k: np.asarray(v) for k, v in jax.device_get(jparams).items()}
    with device_guard("cpu"):
        fresh = TB.BertForPretraining(TB.BertConfig(**DIMS))
    with pytest.raises(ValueError, match="missing"):
        load_params(fresh, {k: v for k, v in flat.items()
                            if k != "nsp_head.bias"})
    with pytest.raises(ValueError, match="extra"):
        load_params(fresh, {**flat, "nope.weight": np.zeros(2)})
    with pytest.raises(ValueError, match="mlm_head.weight"):
        load_params(fresh, {**flat, "mlm_head.weight": np.zeros((2, 2))})
    # BERT-base's leaves the fused Adam gate admits (shapes only)
    from paddle_tpu_torch.kernels.fused_adam import supported
    cfg = TB.BertConfig()
    H, F, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                  cfg.num_layers)
    shapes = ([(V, H), (cfg.max_position_embeddings, H),
               (cfg.type_vocab_size, H)] + [(H, H)] * (4 * L + 2)
              + [(H, F), (F, H)] * L + [(H, V), (H, 2)])
    admitted = 0
    for shp in shapes:
        p = torch.empty(shp, device="meta")
        slot = {"moment1": p, "moment2": p}
        admitted += supported(p, p, slot)
    assert admitted == 77
