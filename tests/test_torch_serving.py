"""The port's ``ServingEngine`` (``paddle_tpu_torch.inference.serving``) on
the CPU: the whole slice against the JAX engine on the same weights and
requests, and the scheduler's own contracts (admission under page
pressure, per-request rejection, one dispatch per step, the options that
belong to later slices, the device default, and an import that pulls in
neither JAX nor the JAX package). The two-program path and the quantized
pools have their own files (``test_torch_two_program_serving.py``,
``test_torch_kv_cache.py``)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import gpt as JG
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_jax

DIMS = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128)
JCFG = JG.GPTConfig(**DIMS, dtype=jnp.float32)
TCFG = TG.GPTConfig(**DIMS, dtype=torch.float32)
ENGINE = dict(max_batch=2, block_size=8, num_blocks=24, max_blocks_per_seq=8,
              chunk=8, decode_burst=4, adaptive_mix=False, ragged=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jparams():
    return JG.init_hybrid_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.device_get(jparams), "cpu")


def mk(params, **kw):
    return ServingEngine(params, TCFG, device="cpu", **{**ENGINE, **kw})


def _serve(engine, prompts, news, eos=None):
    """Submit all, run; returns (outputs by request, on_token stream)."""
    stream = []
    rids = [engine.add_request(p, n, eos_id=(eos or {}).get(i),
                               on_token=lambda rid, t: stream.append((rid, t)))
            for i, (p, n) in enumerate(zip(prompts, news))]
    res = engine.run()
    assert not res.leftover
    return [res[r] for r in rids], stream, res


def test_engine_matches_jax_engine(jparams, tparams):
    """The whole slice: same converted weights, same requests (mixed
    prompt lengths, one stopping at EOS), greedy outputs and the streamed
    tokens identical to the JAX ragged engine's."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 97, (n,)) for n in (5, 13, 9, 16)]
    news = [6, 3, 9, 5]
    free, _, _ = _serve(mk(tparams), prompts, news)
    eos = {2: free[2][3]}  # request 2 stops at its fourth token
    out_t, stream_t, res = _serve(mk(tparams), prompts, news, eos)
    out_j, stream_j, _ = _serve(JaxEngine(jparams, JCFG, **ENGINE), prompts,
                                news, eos)
    assert out_t == out_j
    assert sorted(stream_t) == sorted(stream_j)
    assert len(out_t[2]) == free[2].index(eos[2]) + 1 < news[2]
    assert all(res.statuses[r] == "ok" for r in res.statuses)
    # each request's stream is its output, in order
    for rid, out in enumerate(out_t):
        assert [t for r, t in stream_t if r == rid] == out


def _drive(eng):
    """Step by hand until idle; returns {rid: finished Request}."""
    done = {}
    while eng.has_work():
        for r in eng.step():
            done[r.rid] = r
    return done


def test_admission_waits_for_pages_and_recycles_blocks(tparams):
    eng = mk(tparams, max_batch=3, num_blocks=7)   # 6 usable pages
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 97, (12,)) for _ in range(5)]
    rids = [eng.add_request(p, 6) for p in prompts]  # 18 tokens: 3 pages
    done = {r.rid: r for r in eng.step()}
    # two requests hold all 6 pages; the third slot stays empty and the
    # head of the queue waits for pages
    assert sum(s is not None for s in eng.slots) == 2
    assert eng.free_pages() == 0 and len(eng.queue) == 3
    seen = set()
    while eng.has_work():
        for s in eng.slots:
            if s is not None:
                seen.update(int(b) for b in eng.tables[s.slot] if b)
        done.update({r.rid: r for r in eng.step()})
    assert eng.free_pages() == 6 and not eng.refcount.any()
    assert seen == set(range(1, 7))                # reused; never block 0
    assert all(done[r].status == "ok" for r in rids)
    # waiting changed nothing: each output equals a solo run's
    for rid, p in zip(rids, prompts):
        solo = mk(tparams, max_batch=1)
        r = solo.add_request(p, 6)
        assert solo.run()[r] == done[rid].output


def test_oversized_request_fails_alone(tparams):
    eng = mk(tparams)
    rng = np.random.RandomState(3)
    rids = [eng.add_request(rng.randint(0, 97, (6,)), 4),
            eng.add_request(rng.randint(0, 97, (60,)), 10),  # 9 > 8 pages
            eng.add_request(rng.randint(0, 97, (6,)), 4)]
    done = _drive(eng)
    big = done[rids[1]]
    assert big.status == "failed" and big.output == []
    assert "can never be admitted" in big.error
    assert done[rids[0]].status == done[rids[2]].status == "ok"
    assert len(done[rids[0]].output) == len(done[rids[2]].output) == 4
    assert "requests_rejected_total 1" in eng.metrics_text()


def test_one_dispatch_per_step_in_metrics(tparams):
    eng = mk(tparams)
    rng = np.random.RandomState(4)
    for n in (5, 11, 3):
        eng.add_request(rng.randint(0, 97, (n,)), 5)
    eng.run()
    assert eng.dispatches == eng.engine_steps > 0
    assert eng.decode_microsteps >= eng.dispatches
    text = eng.metrics_text()
    assert "paddle_tpu_serving_dispatches_per_step 1" in text
    assert "# TYPE paddle_tpu_serving_ttft_seconds summary" in text
    assert "paddle_tpu_serving_tokens_total 15" in text


def test_adaptive_mix_shortens_burst_under_queue_pressure(tparams):
    eng = mk(tparams, adaptive_mix=True, decode_burst=8)
    assert eng._pick_burst(0) == 8
    eng._prom.gauge_set("queue_depth", 3)
    assert eng._pick_burst(0) == 2          # 8 // (3 + 1)
    assert eng._pick_burst(4) == 1
    eng._prom.gauge_set("queue_depth", 0)
    eng.ttft_slo_s = 0.01
    eng._prom.summary_observe("ttft_seconds", 1.0, window=16)
    assert eng._pick_burst(0) == 4          # SLO miss: pressure 1


def test_temperature_sampling_seeded(tparams):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 97, (n,)) for n in (7, 4)]

    def run(seed):
        eng = mk(tparams, seed=seed)
        rids = [eng.add_request(p, 8, temperature=1.0) for p in prompts]
        res = eng.run()
        return [res[r] for r in rids]

    a, b = run(7), run(7)
    assert a == b
    assert all(0 <= t < 97 and len(o) == 8 for o in a for t in o)


@pytest.mark.parametrize("kw", [
    dict(int8=True), dict(mesh=object()), dict(prefix_share=True),
    dict(spec_decode_k=2), dict(queue_max=4), dict(shed=True),
    dict(preempt=True)])
def test_later_slice_options_raise(tparams, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mk(tparams, **kw)


def test_flags_keep_jax_defaults_and_select_the_ragged_path(tparams):
    from paddle_tpu import flags as JF
    from paddle_tpu_torch import flags as TF
    for name in ("paged_block_size", "serving_decode_burst",
                 "serving_prefill_chunk", "serving_ragged",
                 "serving_kv_cache_dtype", "serving_adaptive_mix"):
        assert (TF._REGISTRY[f"FLAGS_{name}"].default
                == JF._REGISTRY[f"FLAGS_{name}"].default), name
    kw = {k: v for k, v in ENGINE.items() if k != "ragged"}
    TF.set_flags({"serving_ragged": True})
    try:
        eng = ServingEngine(tparams, TCFG, device="cpu", **kw)
        rid = eng.add_request(np.arange(5), 3)
        assert len(eng.run()[rid]) == 3
    finally:
        TF.set_flags({"serving_ragged": False})


def test_default_device_is_cuda_and_raises_without_it(tparams, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tparams, TCFG, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.init_hybrid_params(TCFG, 0, device=None)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = ("inference.serving", "inference.ragged_step", "kernels._build",
            "kernels.paged_attention", "kernels.ragged_paged_attention",
            "kernels.flash_attention", "kernels.fused_adam",
            "nn.functional.flash_attention", "quantization.kv_cache",
            "models.convert", "models.gpt", "optimizer.optimizer",
            "optimizer.lr", "observability.flops")
    code = ("import sys, paddle_tpu_torch, "
            + ", ".join(f"paddle_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
