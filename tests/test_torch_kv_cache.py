"""The port's quantized KV pool (``paddle_tpu_torch.quantization.kv_cache``),
the quantized branch of its ragged attention, and the int8 / fp8 engines,
against the JAX package on the CPU.

The append is the reference's arithmetic op for op, so pools and scales are
compared bit for bit. The attention's plain version is held to the JAX
kernel (interpret mode) with scales at 1e-5 (fp32) and 1e-2 of the largest
output (bf16 q), and, as ``test_ragged_serving`` holds the JAX kernel, to an
exact-float reference at 0.08 (the int8 grid's error). The engines are held
to the JAX engines token for token and to JAX's own gates (determinism,
agreement with the float pool, the ragged-path requirement). Inputs are
made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.kernels.pallas.ragged_paged_attention import (
    ragged_paged_attention as jax_rpa)
from paddle_tpu.models import gpt as JG
from paddle_tpu.quantization import kv_cache as JKV
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_jax
from paddle_tpu_torch.quantization import kv_cache as TKV

DTYPES = {"int8": (jnp.int8, torch.int8),
          "fp8_e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bits(a):
    """Pool or scale contents as raw bits (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.element_size() == 1 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _append_both(kind, steps, tables, H=2, NB=12, bs=8, D=16, seed=0):
    """Run the same appends through both packages; returns the JAX and the
    port's (pool, scales) after each step."""
    jd, td = DTYPES[kind]
    rng = np.random.RandomState(seed)
    jp, js = jnp.zeros((H, NB, bs, D), jd), jnp.zeros((H, NB), jnp.float32)
    tp, ts = torch.zeros((H, NB, bs, D), dtype=td), torch.zeros((H, NB))
    R = tables.shape[0]
    out = []
    for i, (pos0, q_lens, C) in enumerate(steps):
        # later steps carry larger values: they grow the page scales, so
        # the pages' earlier tokens are requantized
        val = (rng.randn(R, C, H, D) * (1 + 2 * i)).astype(np.float32)
        pos0, q_lens = np.asarray(pos0, np.int32), np.asarray(q_lens,
                                                              np.int32)
        jp, js = JKV.append_tokens_quantized(
            jp, js, jnp.asarray(val), jnp.asarray(pos0), jnp.asarray(q_lens),
            jnp.asarray(tables), bs)
        rt = TKV.append_tokens_quantized(
            tp, ts, torch.from_numpy(val), torch.from_numpy(pos0),
            torch.from_numpy(q_lens), torch.from_numpy(tables), bs)
        assert rt[0] is tp and rt[1] is ts          # in place
        out.append(((jp, js), (tp.clone(), ts.clone())))
    return out


@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
def test_append_is_bit_equal_to_jax(kind):
    """Prefill chunks, decode tokens (one row idle with q_len 0) and a chunk
    that crosses a page boundary into the table's last slot. Block 0 is the
    scratch block idle rows and overhanging slots write: its contents are
    unspecified in both packages."""
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    steps = [([0, 0, 0], [8, 5, 3], 8),       # fresh prefills
             ([8, 5, 3], [3, 2, 8], 8),       # chunks mid-sequence
             ([11, 7, 11], [1, 0, 8], 8),     # decode, idle row, chunk
             ([12, 8, 19], [1, 1, 8], 8)]     # row 2 into its last slot
    for (jp, js), (tp, ts) in _append_both(kind, steps, tables):
        assert np.array_equal(_bits(jp)[:, 1:], _bits(tp)[:, 1:])
        assert np.array_equal(_bits(js)[:, 1:], _bits(ts)[:, 1:])


@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
def test_append_into_last_table_page(kind):
    """The regression of test_ragged_serving: a chunk landing in the row's
    last table slot overhangs the table; the overhang goes to block 0 and
    the appended tokens survive, equal to JAX's and within the grid's
    error of the exact values."""
    bs = 8
    tables = np.array([[1, 2]], np.int32)
    (jp, js), (tp, ts) = _append_both(kind, [([bs], [bs], bs)], tables,
                                      NB=6, seed=3)[0]
    assert np.array_equal(_bits(jp)[:, 1:], _bits(tp)[:, 1:])
    assert np.array_equal(_bits(js), _bits(ts))
    rng = np.random.RandomState(3)
    want = np.moveaxis(rng.randn(1, bs, 2, 16).astype(np.float32)[0], 1, 0)
    deq = (tp[:, 2].float() * ts[:, 2][:, None, None]
           / TKV._qmax(tp.dtype)).numpy()
    # int8: half a step of 127 over the absmax; e4m3: 3 mantissa bits
    tol = 0.05 if kind == "int8" else 0.25
    assert np.abs(deq - want).max() < tol


def test_reset_page_scales_matches_jax():
    rng = np.random.RandomState(1)
    scales = rng.rand(2, 3, 10).astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0]], np.int32)
    fresh = np.array([True, False, True])
    ref = JKV.reset_page_scales(jnp.asarray(scales), jnp.asarray(tables),
                                jnp.asarray(fresh))
    got = torch.from_numpy(scales.copy())
    out = TKV.reset_page_scales(got, torch.from_numpy(tables),
                                torch.from_numpy(fresh))
    assert out is got
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert (got[:, :, [1, 2, 6]] == 0).all() and (got[:, :, 3:6] > 0).all()


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3", "bf16", "f32"])
def test_dtypes_and_blocks_for_budget_match_jax(name):
    jd, jq = JKV.kv_cache_dtype(name)
    td, tq = TKV.kv_cache_dtype(name)
    assert jq == tq and jnp.dtype(jd).itemsize == td.itemsize
    assert str(jnp.dtype(jd)) == str(td).split(".")[-1]
    for budget in (10 ** 6, 12_345_678, 3 * 2 ** 30):
        args = (budget, 24, 16, 32, 128)
        assert (TKV.kv_pool_blocks_for_budget(*args, td)
                == JKV.kv_pool_blocks_for_budget(*args, jd))
    with pytest.raises(ValueError):
        TKV.kv_cache_dtype("int4")


# ---------------------------------------------------------------------------
# the ragged kernel's quantized branch
# ---------------------------------------------------------------------------
def _quantized_case(kind, hq, hkv, seed=0, D=16, bs=8, nb=5, NB=16, C=6):
    """Pools filled by the appends (two per row, so pages are requantized);
    rows: a decode row, a chunk mid-sequence, an empty row, a fresh
    prefill (the layout of test_torch_ragged_attention)."""
    rng = np.random.RandomState(seed)
    q_lens = np.array([1, 6, 0, 3], np.int32)
    kv_lens = np.array([19, 11, 0, 3], np.int32)
    tables = np.zeros((4, nb), np.int32)
    blk = 1
    for r in range(4):
        for j in range(-(-int(kv_lens[r]) // bs)):
            tables[r, j] = blk
            blk += 1
    half = kv_lens // 2
    pools = []
    for _ in range(2):
        steps = [([0] * 4, half, 19), (half, kv_lens - half, 19)]
        (jp, js), (tp, ts) = _append_both(kind, steps, tables, H=hkv, NB=NB,
                                          bs=bs, D=D,
                                          seed=rng.randint(1000))[-1]
        pools.append((jp, js, tp, ts))
    return dict(q=rng.randn(4, C, hq, D).astype(np.float32), pools=pools,
                tables=tables, q_lens=q_lens, kv_lens=kv_lens,
                scale=1.0 / np.sqrt(D))


def _attend_both(case, jdtype, tdtype):
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = case["pools"]
    t = {n: case[n] for n in ("tables", "q_lens", "kv_lens")}
    ref = jax_rpa(jnp.asarray(case["q"]).astype(jdtype), jk, jv,
                  *(jnp.asarray(t[n]) for n in t), case["scale"], jks, jvs)
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(
        torch.from_numpy(case["q"]).to(tdtype), tk, tv,
        *(torch.from_numpy(t[n]) for n in t), case["scale"], tks, tvs)
    assert RPA.ragged_paged_attention.LAUNCHES == n   # CPU: the plain version
    assert out.dtype == tdtype
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_quantized_plain_matches_jax_kernel(kind, hq, hkv):
    case = _quantized_case(kind, hq, hkv)
    out, ref = _attend_both(case, jnp.float32, torch.float32)
    assert np.abs(out - ref).max() <= 1e-5
    for r, ql in enumerate(case["q_lens"]):
        assert (out[r, ql:] == 0).all()
    out, ref = _attend_both(case, jnp.bfloat16, torch.bfloat16)
    assert np.abs(out - ref).max() / np.abs(ref).max() <= 1e-2


def test_int8_attention_close_to_exact_floats():
    """test_ragged_serving's bound: attention over int8 pools within 0.08
    of attention over the exact float tokens."""
    rng = np.random.RandomState(1)
    hkv, NB, bs, D, R, C, nb = 2, 10, 8, 16, 2, 8, 4
    tables = np.zeros((R, nb), np.int32)
    tables[0, :2], tables[1, :2] = [1, 2], [3, 4]
    kf = rng.randn(R, C, hkv, D).astype(np.float32)
    vf = rng.randn(R, C, hkv, D).astype(np.float32)
    pos0 = torch.zeros(R, dtype=torch.int32)
    q_lens = torch.tensor([8, 5], dtype=torch.int32)
    tab = torch.from_numpy(tables)
    pools = []
    for val in (kf, vf):
        pool = torch.zeros((hkv, NB, bs, D), dtype=torch.int8)
        scales = torch.zeros((hkv, NB))
        TKV.append_tokens_quantized(pool, scales, torch.from_numpy(val),
                                    pos0, q_lens, tab, bs)
        pools += [pool, scales]
    exact = [torch.zeros((hkv, NB, bs, D)) for _ in range(2)]
    for r in range(R):
        for t in range(int(q_lens[r])):
            b, o = tables[r, t // bs], t % bs
            exact[0][:, b, o] = torch.from_numpy(kf[r, t])
            exact[1][:, b, o] = torch.from_numpy(vf[r, t])
    q = torch.from_numpy(rng.randn(R, C, hkv, D).astype(np.float32))
    scale = 1.0 / np.sqrt(D)
    out = RPA.ragged_paged_attention(q, pools[0], pools[2], tab, q_lens,
                                     q_lens, scale, pools[1], pools[3])
    ref = RPA.ragged_paged_attention(q, exact[0], exact[1], tab, q_lens,
                                     q_lens, scale)
    assert (out - ref).abs().max().item() < 0.08


@pytest.mark.parametrize("bad", ["no_scales", "scales_for_float_pool",
                                 "fp16_scales", "mixed_pools",
                                 "scales_shape"])
def test_kernel_checks_refuse_mismatched_scales(bad):
    case = _quantized_case("int8", 4, 4)
    (_, _, tk, tks), (_, _, tv, tvs) = case["pools"]
    args = [torch.from_numpy(case["q"]).to(torch.bfloat16), tk, tv,
            *(torch.from_numpy(case[n]) for n in
              ("tables", "q_lens", "kv_lens"))]
    scales = [tks, tvs]
    RPA._check_cuda(*args, *scales)              # the unchanged inputs pass
    if bad == "no_scales":
        scales = [None, None]
    elif bad == "scales_for_float_pool":
        args[1], args[2] = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    elif bad == "fp16_scales":
        scales = [s.half() for s in scales]
    elif bad == "mixed_pools":
        args[2] = tv.view(torch.float8_e4m3fn)
    elif bad == "scales_shape":
        scales = [s[:, :-1] for s in scales]
    with pytest.raises((TypeError, ValueError)):
        RPA._check_cuda(*args, *scales)


# ---------------------------------------------------------------------------
# the int8 / fp8 engines
# ---------------------------------------------------------------------------
DIMS = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=128)
JCFG = JG.GPTConfig(**DIMS, dtype=jnp.float32)
TCFG = TG.GPTConfig(**DIMS, dtype=torch.float32)
ENGINE = dict(max_batch=2, block_size=8, num_blocks=24, max_blocks_per_seq=8,
              chunk=8, decode_burst=4, adaptive_mix=False, ragged=True)


@pytest.fixture(scope="module")
def jparams():
    return JG.init_hybrid_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jax.device_get(jparams), "cpu")


def _serve(engine, prompts, news):
    rids = [engine.add_request(p, n) for p, n in zip(prompts, news)]
    res = engine.run()
    return [res[r] for r in rids]


def _prompts(seed=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, (n,)) for n in (9, 13, 4)], [6, 6, 5]


@pytest.mark.parametrize("kind", ["int8", "fp8_e4m3"])
def test_quantized_engine_matches_jax_engine(jparams, tparams, kind):
    prompts, news = _prompts()
    got = _serve(ServingEngine(tparams, TCFG, device="cpu",
                               kv_cache_dtype=kind, **ENGINE), prompts, news)
    want = _serve(JaxEngine(jparams, JCFG, kv_cache_dtype=kind, **ENGINE),
                  prompts, news)
    assert got == want


def test_int8_engine_gates(tparams):
    """JAX's own gates on the port: two fresh engines give the same
    outputs; >= 75 % of tokens agree with the float pool's and every first
    token does; the scales live per (layer, kv head, block)."""
    prompts, news = _prompts()

    def run(kv):
        eng = ServingEngine(tparams, TCFG, device="cpu", kv_cache_dtype=kv,
                            **ENGINE)
        return _serve(eng, prompts, news), eng

    (q1, eng), (q2, _), (fp, _) = run("int8"), run("int8"), run("auto")
    assert q1 == q2
    assert eng.k_pools.dtype == torch.int8
    assert eng.k_scales.shape == (2, 4, 24) and eng.k_scales.max() > 0
    total = sum(len(o) for o in fp)
    agree = sum(a == b for o1, o2 in zip(fp, q1) for a, b in zip(o1, o2))
    assert agree / total >= 0.75, (fp, q1)
    assert all(o1[0] == o2[0] for o1, o2 in zip(fp, q1))


def test_page_scale_reset_on_block_reuse(tparams):
    """A recycled block must not inherit a stale range: a request that
    reuses another's freed blocks gives a clean engine's output."""
    rng = np.random.RandomState(11)
    p1, p2 = rng.randint(0, 97, (8,)), rng.randint(0, 97, (8,))
    kw = dict(ENGINE, max_batch=1, num_blocks=5)
    eng = ServingEngine(tparams, TCFG, device="cpu", kv_cache_dtype="int8",
                        **kw)
    r1, r2 = eng.add_request(p1, 4), eng.add_request(p2, 4)
    res = eng.run()
    clean = ServingEngine(tparams, TCFG, device="cpu", kv_cache_dtype="int8",
                          **kw)
    rc = clean.add_request(p2, 4)
    assert clean.run()[rc] == res[r2], (res[r1], res[r2])


def test_int8_pool_admits_2x_at_a_fixed_budget():
    cfg = TG.GPTConfig(vocab_size=97, hidden_size=64, num_layers=2,
                       num_heads=4, max_seq_len=128, dtype=torch.float32)
    params = TG.init_hybrid_params(cfg, 0, "cpu")
    budget = 9 * (2 * cfg.num_layers * cfg.num_heads * 16 * cfg.head_dim * 2)

    def admitted(kv):
        eng = ServingEngine(params, cfg, device="cpu", max_batch=16,
                            block_size=16, kv_pool_bytes=budget,
                            max_blocks_per_seq=4, chunk=8, ragged=True,
                            kv_cache_dtype=kv)
        for _ in range(16):
            eng.add_request(np.arange(20) % 97, 8)
        eng._admit()
        return sum(s is not None for s in eng.slots)

    assert admitted("int8") / admitted("bf16") >= 1.9


def test_quantized_kv_requires_ragged(tparams):
    with pytest.raises(ValueError, match="ragged"):
        ServingEngine(tparams, TCFG, device="cpu", **dict(
            ENGINE, ragged=False, kv_cache_dtype="int8"))
