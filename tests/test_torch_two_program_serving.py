"""The port's two-program serving path (``ServingEngine(ragged=False)``, the
``FLAGS_serving_ragged`` default) on the CPU: its two programs alone and the
whole engine against the JAX package's, and the scheduler's contracts on
this path (at most two dispatches per step, adaptive bursts, EOS and
streaming, block recycling, per-request rejection, seeded sampling).

Weights come from the JAX package's ``init_hybrid_params`` through
``params_from_jax``; every other input is made with numpy from a seed. The
JAX decode burst reaches its Pallas paged kernel in interpret mode. All fp32
on a tiny GPT (vocab 97, hidden 32, 2 layers, 4 heads): tokens must be
identical and pools agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import serving as JS
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch import flags as TF
from paddle_tpu_torch.inference import serving as TS
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_jax

DIMS = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128)
JCFG = JG.GPTConfig(**DIMS, dtype=jnp.float32)
TCFG = TG.GPTConfig(**DIMS, dtype=torch.float32)
ENGINE = dict(max_batch=2, block_size=8, num_blocks=24, max_blocks_per_seq=8,
              chunk=8, decode_burst=4, adaptive_mix=False,
              adaptive_burst=False, ragged=False)
TOL = 1e-5
BS, NB = 8, 20


@pytest.fixture(scope="module")
def jparams():
    return JG.init_hybrid_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.device_get(jparams), "cpu")


def mk(params, **kw):
    return TS.ServingEngine(params, TCFG, device="cpu", **{**ENGINE, **kw})


def _serve(engine, prompts, news, eos=None):
    """Submit all, run; returns (outputs by request, on_token stream)."""
    stream = []
    rids = [engine.add_request(p, n, eos_id=(eos or {}).get(i),
                               on_token=lambda rid, t: stream.append((rid, t)))
            for i, (p, n) in enumerate(zip(prompts, news))]
    res = engine.run()
    assert not res.leftover
    return [res[r] for r in rids], stream


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_pools(kp_t, kp_j):
    """Block 0 is the scratch block padding and idle slots write: its
    content is unspecified in both packages."""
    err = np.abs(kp_t[:, :, 1:].numpy() - np.asarray(kp_j)[:, :, 1:]).max()
    assert err <= TOL, err


# ---------------------------------------------------------------------------
# the two programs alone
# ---------------------------------------------------------------------------
def test_prefill_chunk_matches_jax(jparams, tparams):
    """Row 0 prefills a fresh prompt (5 of 8 columns valid), row 1 a chunk
    mid-prompt, row 2 is idle (a zero table: its writes go to scratch), row
    3's pad columns run past its full table (JAX drops those writes, the
    port sends them to scratch)."""
    rng = np.random.RandomState(0)
    L, H, D = JCFG.num_layers, JCFG.num_heads, JCFG.head_dim
    P, C, nb = 4, 8, 3
    tokens = rng.randint(0, 97, (P, C)).astype(np.int32)
    pos0 = np.array([0, 8, 0, nb * BS - 2], np.int32)
    last_idx = np.array([4, 7, 0, 1], np.int32)
    tables = np.array([[1, 0, 0], [2, 3, 0], [0, 0, 0], [4, 5, 6]], np.int32)
    temps = np.zeros(P, np.float32)
    kp = rng.randn(L, H, NB, BS, D).astype(np.float32)
    vp = rng.randn(L, H, NB, BS, D).astype(np.float32)
    tok_j, kp_j, vp_j = JS._prefill_chunk(
        jparams, *(jnp.asarray(a) for a in (tokens, pos0, tables, last_idx,
                                             temps)),
        jax.random.PRNGKey(0), jnp.asarray(kp), jnp.asarray(vp), cfg=JCFG,
        bs=BS)
    kp_t, vp_t = _t(kp), _t(vp)
    tok_t, kp_o, vp_o = TS._prefill_chunk(
        tparams, *(_t(a) for a in (tokens, pos0, tables, last_idx, temps)),
        torch.Generator().manual_seed(0), kp_t, vp_t, cfg=TCFG, bs=BS)
    assert kp_o is kp_t and vp_o is vp_t          # pools updated in place
    # the idle row samples from scratch contents: only rows 0, 1, 3 count
    assert tok_t[[0, 1, 3]].tolist() == np.asarray(tok_j)[[0, 1, 3]].tolist()
    _close_pools(kp_t, kp_j)
    _close_pools(vp_t, vp_j)


@pytest.mark.parametrize("K", [1, 4])
def test_decode_burst_matches_jax(jparams, tparams, K):
    """Row 0 decodes with 5 tokens left (and stops at an EOS inside the
    burst when K = 4), row 1 has 2 left so it goes inactive mid-burst, row
    2 is idle."""
    rng = np.random.RandomState(K)
    L, H, D = JCFG.num_layers, JCFG.num_heads, JCFG.head_dim
    tokens = np.array([5, 17, 0], np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([13, 20, 0], np.int32)
    remaining = np.array([5, 2, 0], np.int32)
    temps = np.zeros(3, np.float32)
    kp = rng.randn(L, H, NB, BS, D).astype(np.float32)
    vp = rng.randn(L, H, NB, BS, D).astype(np.float32)

    def both(eos):
        toks_j, kp_j, vp_j, lens_j = JS._decode_burst(
            jparams, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
            *(jnp.asarray(a) for a in (tables, lens, remaining, eos, temps)),
            jax.random.PRNGKey(0), cfg=JCFG, bs=BS, K=K)
        kp_t, vp_t = _t(kp), _t(vp)
        n = PA.paged_decode_attention.LAUNCHES
        toks_t, kp_o, vp_o, lens_t = TS._decode_burst(
            tparams, _t(tokens), kp_t, vp_t,
            *(_t(a) for a in (tables, lens, remaining, eos, temps)),
            torch.Generator().manual_seed(0), cfg=TCFG, bs=BS, K=K)
        assert PA.paged_decode_attention.LAUNCHES == n   # CPU: plain version
        assert kp_o is kp_t and vp_o is vp_t
        assert toks_t.shape == (K, 3)
        assert toks_t.tolist() == np.asarray(toks_j).tolist()
        assert lens_t.tolist() == np.asarray(lens_j).tolist()
        _close_pools(kp_t, kp_j)
        _close_pools(vp_t, vp_j)
        return toks_t

    toks = both(np.full(3, -1, np.int32))
    if K == 4:
        assert toks[2:, 1].tolist() == [0, 0]     # row 1 ran out
        assert toks[:, 2].tolist() == [0] * K     # idle row
        eos = np.array([int(toks[1, 0]), -1, -1], np.int32)
        stopped = both(eos)                       # row 0 stops at its EOS
        assert stopped[2:, 0].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _workload(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, (n,)) for n in (5, 13, 9, 16, 3)], \
        [6, 3, 9, 4, 8]


@pytest.mark.parametrize("adaptive", [False, True])
def test_engine_matches_jax_engine(jparams, tparams, adaptive):
    """Same weights and requests (mixed prompt lengths, one stopping at
    EOS): greedy outputs and streams identical to the JAX two-program
    engine's, and so are the dispatch counts."""
    prompts, news = _workload()
    free, _ = _serve(mk(tparams), prompts, news)
    eos = {2: free[2][3]}
    eng = mk(tparams, adaptive_burst=adaptive)
    out_t, stream_t = _serve(eng, prompts, news, eos)
    jeng = JS.ServingEngine(jparams, JCFG, **{**ENGINE,
                                              "adaptive_burst": adaptive})
    out_j, stream_j = _serve(jeng, prompts, news, eos)
    assert out_t == out_j
    assert sorted(stream_t) == sorted(stream_j)
    assert len(out_t[2]) == free[2].index(eos[2]) + 1 < news[2]
    assert (eng.dispatches, eng.engine_steps, eng.decode_microsteps) == (
        jeng.dispatches, jeng.engine_steps, jeng.decode_microsteps)
    for rid, out in enumerate(out_t):             # streamed in order
        assert [t for r, t in stream_t if r == rid] == out


def test_two_program_matches_ragged_path(tparams):
    prompts, news = _workload(5)
    two, _ = _serve(mk(tparams), prompts, news)
    rag, _ = _serve(mk(tparams, ragged=True), prompts, news)
    assert two == rag


def test_at_most_two_dispatches_per_step(tparams):
    eng = mk(tparams)
    prompts, news = _workload(2)
    for p, n in zip(prompts, news):
        eng.add_request(p, n)
    per_step = []
    while eng.has_work():
        d = eng.dispatches
        eng.step()
        per_step.append(eng.dispatches - d)
    assert max(per_step) == 2 and set(per_step) <= {0, 1, 2}
    text = eng.metrics_text()
    assert "paddle_tpu_serving_dispatches_total" in text
    assert f"paddle_tpu_serving_tokens_total {sum(news)}" in text


def test_adaptive_burst_frees_slots_early(tparams):
    """With a queue waiting, the burst ends when the earliest request can
    finish (the smallest burst length that covers it), so its slot takes
    the queued request after 1 decode micro-step instead of a full burst
    of 8; the outputs do not change."""
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 97, (4,)) for _ in range(3)]
    news = [2, 8, 8]

    def run(adaptive):
        eng = mk(tparams, decode_burst=8, adaptive_burst=adaptive)
        first = {}

        def on_token(rid, tok):
            first.setdefault(rid, eng.decode_microsteps)
        rids = [eng.add_request(p, n, on_token=on_token)
                for p, n in zip(prompts, news)]
        res = eng.run()
        return first[rids[2]], [res[r] for r in rids]

    (waited_a, out_a), (waited_f, out_f) = run(True), run(False)
    assert (waited_a, waited_f) == (1, 8)
    assert out_a == out_f


def test_blocks_recycle_and_an_oversized_request_fails_alone(tparams):
    eng = mk(tparams, max_batch=3, num_blocks=7)       # 6 usable pages
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 97, (12,)) for _ in range(4)]
    rids = [eng.add_request(p, 6) for p in prompts]    # 3 pages each
    big = eng.add_request(rng.randint(0, 97, (60,)), 10)   # 9 > 8 pages
    done, seen = {}, set()
    while eng.has_work():
        for s in eng.slots:
            if s is not None:
                seen.update(int(b) for b in eng.tables[s.slot] if b)
        done.update({r.rid: r for r in eng.step()})
    assert done[big].status == "failed" and done[big].output == []
    assert "can never be admitted" in done[big].error
    assert eng.free_pages() == 6 and not eng.refcount.any()
    assert seen == set(range(1, 7))                    # reused; never block 0
    for rid, p in zip(rids, prompts):
        assert done[rid].status == "ok"
        solo = mk(tparams, max_batch=1)
        r = solo.add_request(p, 6)
        assert solo.run()[r] == done[rid].output


def test_temperature_sampling_is_seeded(tparams):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 97, (n,)) for n in (7, 4)]

    def run(seed):
        eng = mk(tparams, seed=seed)
        rids = [eng.add_request(p, 8, temperature=1.0) for p in prompts]
        res = eng.run()
        return [res[r] for r in rids]

    a = run(7)
    assert a == run(7)
    assert all(0 <= t < 97 and len(o) == 8 for o in a for t in o)


def test_default_engine_takes_the_two_program_path(tparams):
    """No ``ragged`` argument: FLAGS_serving_ragged (off) picks the
    two-program path, as in the JAX package."""
    kw = {k: v for k, v in ENGINE.items() if k != "ragged"}
    assert TF.flag("serving_ragged") is False
    eng = TS.ServingEngine(tparams, TCFG, device="cpu", **kw)
    assert eng.ragged is False and sorted(eng._decode_k) == [1, 2, 4]
    rid = eng.add_request(np.arange(9), 5)
    assert len(eng.run()[rid]) == 5
    assert eng.dispatches > eng.engine_steps      # prefill + decode steps
