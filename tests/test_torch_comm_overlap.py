"""The port's bucketed, microbatched and int8 error-feedback dp gradient
sync (``paddle_tpu_torch/distributed/comm_overlap``) against the JAX
package's ``distributed.comm_overlap`` on the virtual CPU mesh.

Metadata and arithmetic first, in this process: the bucket plans (the same
partition of leaves for the same shapes, dtypes and ``bucket_bytes``),
pack / unpack, and ``quantize_int8`` (round half to even, bit for bit).
Then the collectives and the engine, the ranks in child processes over
gloo (``torch_dist_workers``, one spawn at world 2 for the file): the int8
error-feedback all-reduce of one bucket, the tiny GPT of
``tests/test_zero_stages.py`` through ``build_hybrid_train_step`` with the
bucketed sync over two comm microbatches (stages 0, 1 and 3) and with the
int8 error feedback, and the MLP of ``tests/test_comm_overlap.py`` through
``build_train_step``, each against the JAX engine on two devices.

Tolerances: the full-precision paths hold ``tests/test_zero_stages.py``'s
2e-5 on every loss and 2e-4 on the final parameters (the MLP
``tests/test_comm_overlap.py``'s 1e-5 on losses, 1e-4 / 1e-5 on
parameters); the int8 path that file's 1e-2 relative on the losses (two
implementations of the same rounding: a value within an ulp of a code
boundary may round the other way, and the error feedback then carries a
different residual).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import comm_overlap as jco
from paddle_tpu.models import gpt as JG
from paddle_tpu.models.hybrid_engine import build_train_step as j_build
from paddle_tpu.utils import shard_map

import torch
import torch_dist_workers as W
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import comm_overlap as tco
from paddle_tpu_torch.models import gpt as TG

CFG = JG.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
                   max_seq_len=16, dtype=jnp.float32)
BUCKET_MB = 1e-3           # several buckets over the tiny trees

GPT_CASES = {
    "overlap": dict(comm_overlap=dict(bucket_mb=BUCKET_MB, microbatches=2)),
    "overlap_z1": dict(zero_stage=1, comm_overlap=dict(
        bucket_mb=BUCKET_MB, microbatches=2)),
    "overlap_z3": dict(zero_stage=3, comm_overlap=dict(
        bucket_mb=BUCKET_MB, microbatches=2)),
    "int8": dict(comm_overlap=dict(bucket_mb=BUCKET_MB, quantize="int8")),
}
PORT_GPT_CASES = {
    "plain": dict(),
    "int8_m2_a": dict(comm_overlap=dict(bucket_mb=BUCKET_MB,
                                        quantize="int8", microbatches=2)),
    "int8_m2_b": dict(comm_overlap=dict(bucket_mb=BUCKET_MB,
                                        quantize="int8", microbatches=2)),
}
MLP_CASES = {
    "mono": dict(comm_overlap=None),
    "bucketed": dict(comm_overlap=dict(bucket_mb=1e-4)),
    "micro2": dict(comm_overlap=dict(bucket_mb=1e-4, microbatches=2)),
    "z1": dict(comm_overlap=None, zero1_dp=True),
    "z1_overlap": dict(comm_overlap=dict(bucket_mb=1e-4), zero1_dp=True),
    "bf16_mono": dict(comm_overlap=None, grad_reduce_dtype=torch.bfloat16),
    "bf16_bucketed": dict(comm_overlap=dict(bucket_mb=1e-4,
                                            reduce_dtype=torch.bfloat16)),
    "skips": dict(comm_overlap=None, skips_grad_sync=True),
    "skips_overlap": dict(comm_overlap=dict(bucket_mb=1e-4),
                          skips_grad_sync=True),
}


# ---------------------------------------------------------------------------
# bucket plans, pack / unpack, the quantizer
# ---------------------------------------------------------------------------
_TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
        jnp.float16: torch.float16}


def _plan_rows(plan):
    return [[(s.leaf_index, tuple(s.shape), s.offset) for s in b.slots]
            for b in plan.buckets]


@pytest.mark.parametrize("bucket_bytes", [0, 1, 4 * 200, 1000, 1e9])
@pytest.mark.parametrize("reverse", [True, False])
def test_bucket_plan_equals_jax(bucket_bytes, reverse):
    sizes = [(100,), (5,), (300,), (7, 3), (9,), (2, 2, 2), (1000,)]
    dts = [jnp.float32, jnp.bfloat16, jnp.float32, jnp.float16,
           jnp.float32, jnp.bfloat16, jnp.float32]
    jl = [jax.ShapeDtypeStruct(s, d) for s, d in zip(sizes, dts)]
    tl = [tco.ShapeDtype(s, _TDT[d]) for s, d in zip(sizes, dts)]
    jl[4] = tl[4] = None        # a frozen leaf
    jp = jco.build_bucket_plan(jl, bucket_bytes, reverse=reverse)
    tp = tco.build_bucket_plan(tl, bucket_bytes, reverse=reverse)
    assert _plan_rows(tp) == _plan_rows(jp)
    assert [b.nbytes for b in tp.buckets] == [b.nbytes for b in jp.buckets]
    assert tp.local_sizes() == jp.local_sizes()


@pytest.mark.parametrize("dp", [1, 2, 8])
def test_ef_plan_on_the_gpt_tree_equals_jax(dp):
    """The residual plan over each rank's gradient shapes of the GPT tree
    under hybrid_param_specs, and the local shapes themselves."""
    jmesh = jdist.build_mesh({"dp": dp, "pp": 1, "mp": 1},
                             devices=jax.devices()[:dp])
    tmesh = type("M", (), {"shape": {"dp": dp, "pp": 1, "mp": 1},
                           "axis_names": ("dp", "pp", "mp")})()
    jex = jax.eval_shape(lambda: JG.init_hybrid_params(
        CFG, jax.random.PRNGKey(0)))
    tcfg = W.gpt_cfg()
    tex = TG.init_hybrid_params(tcfg, 0, device="meta")
    for mb in (1e-3, 4.0):
        jp = jco.ef_plan_for(jex, JG.hybrid_param_specs(CFG), jmesh,
                             mb * (1 << 20))
        tp = tco.ef_plan_for(tex, TG.hybrid_param_specs(tcfg), tmesh,
                             mb * (1 << 20))
        assert _plan_rows(tp) == _plan_rows(jp)
    assert tco.ef_residual_specs(tp, tmesh) == [
        tuple(s) for s in jco.ef_residual_specs(jp, jmesh)]
    assert tco.local_shape((8, 6), ("pp", "mp"), tmesh) == (8, 6)


def test_pack_unpack_roundtrip_mixed_dtypes():
    rng = np.random.RandomState(0)
    arrs = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(
        np.float32), rng.randn(2, 2, 2).astype(np.float32)]
    jl = [jnp.asarray(arrs[0]), jnp.asarray(arrs[1]).astype(jnp.bfloat16),
          jnp.asarray(arrs[2])]
    tl = [torch.from_numpy(arrs[0]),
          torch.from_numpy(arrs[1]).to(torch.bfloat16),
          torch.from_numpy(arrs[2])]
    (jb,) = jco.build_bucket_plan(jl, 0).buckets
    (tb,) = tco.build_bucket_plan(tl, 0).buckets
    jflat, tflat = jco.pack_bucket(jl, jb), tco.pack_bucket(tl, tb)
    assert tflat.dtype == torch.float32     # promoted, not truncated
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    out = dict(tco.unpack_bucket(tflat, tb))
    for i, leaf in enumerate(tl):
        assert out[i].dtype == leaf.dtype and out[i].shape == leaf.shape
        np.testing.assert_array_equal(out[i].float().numpy(),
                                      leaf.float().numpy())


def test_quantize_int8_equals_jax_bit_for_bit():
    """Round half to even (``jnp.round``), the clip to +-127, and the codes
    of exact ties, over values across the grid."""
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(4096).astype(np.float32) * 3,
                        np.arange(-130, 131, 0.5, dtype=np.float32),
                        np.array([1e30, -1e30, 0.0, -0.0], np.float32)])
    for scale in (np.float32(0.03), np.float32(1.0), np.float32(2.0)):
        jq = np.asarray(jco.quantize_int8(jnp.asarray(x), jnp.asarray(scale)))
        tq = tco.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), jq)
        jd = np.asarray(jco.dequantize_int8(jnp.asarray(jq),
                                            jnp.asarray(scale)))
        np.testing.assert_array_equal(
            tco.dequantize_int8(tq, torch.tensor(scale)).numpy(), jd)


def test_config_from_flags_gating():
    assert tco.config_from_flags() is None      # all defaults: off
    keep = {k: tflags.flag(k) for k in ("comm_bucket_mb", "comm_quantize",
                                         "comm_overlap_microbatches")}
    try:
        tflags.set_flags({"FLAGS_comm_bucket_mb": 8.0,
                          "FLAGS_comm_quantize": "int8",
                          "FLAGS_comm_overlap_microbatches": 4})
        assert tco.config_from_flags() == tco.CommOverlapConfig(
            bucket_mb=8.0, quantize="int8", microbatches=4)
    finally:
        tflags.set_flags(keep)
    with pytest.raises(Exception, match="quantize"):
        tco.CommOverlapConfig(quantize="fp4")
    with pytest.raises(Exception, match="microbatches"):
        tco.CommOverlapConfig(microbatches=0)


# ---------------------------------------------------------------------------
# the multi-rank half: one spawn at world 2
# ---------------------------------------------------------------------------
def _mlp_np():
    rng = np.random.RandomState(0)
    params = {"w": (rng.randn(16, 8) * 0.3).astype(np.float32),
              "b": np.zeros((8,), np.float32),
              "h": (rng.randn(8, 8) * 0.3).astype(np.float32)}
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 8).astype(np.float32)
    return params, xs, ys


def _psum_inputs():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 64).astype(np.float32),
            (rng.randn(2, 64) * 0.01).astype(np.float32))


def _data():
    rng = np.random.RandomState(0)
    return (rng.randint(0, 64, (8, 16)), rng.randint(0, 64, (8, 16)))


@pytest.fixture(scope="module")
def port_runs():
    init_np = jax.device_get(JG.init_hybrid_params(CFG,
                                                   jax.random.PRNGKey(0)))
    tokens, labels = _data()
    xs, res = _psum_inputs()
    return W.spawn(W.run_many, 2, [
        ("gpt", W.gpt_job, (init_np, tokens, labels,
                            {**GPT_CASES, **PORT_GPT_CASES})),
        ("mlp", W.mlp_job, (_mlp_np(), MLP_CASES)),
        ("psum", W.quantized_psum_job, (xs, res))])


def test_ef_quantized_psum_matches_jax(port_runs):
    """One bucket's int8 error-feedback all-reduce at world 2: the reduced
    mean and each rank's new residual equal the JAX collective's bit for
    bit, each residual is within half a code of the input, and
    ``residual_sq_norm`` counts each rank's residual once."""
    xs, res = _psum_inputs()
    mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])

    def local(x, r):
        return jco.ef_quantized_psum(x, r, "dp", mean_divisor=2.0)
    fn = shard_map(local, mesh=mesh, in_specs=(P("dp"), P("dp")),
                   out_specs=(P("dp"), P("dp")))
    jred, jres = (np.asarray(a) for a in fn(jnp.asarray(xs.reshape(-1)),
                                            jnp.asarray(res.reshape(-1))))
    jred, jres = jred.reshape(2, 64), jres.reshape(2, 64)
    for r in range(2):
        red, new_r, sq = port_runs[r]["psum"]
        np.testing.assert_array_equal(red, jred[r])
        np.testing.assert_array_equal(new_r, jres[r])
        # residual_sq_norm: each distinct element once, summed over ranks
        np.testing.assert_allclose(sq, float(np.sum(jres.astype(
            np.float64) ** 2)), rtol=1e-5)
    scale = np.abs(xs + res).max() / 127.0
    assert np.abs(port_runs[0]["psum"][1]).max() <= scale * 0.5 + 1e-6


_JAX = {}


def _jax_gpt(name):
    if name not in _JAX:
        case = dict(GPT_CASES[name])
        co = case.pop("comm_overlap")
        mesh = jdist.build_mesh({"dp": 2, "pp": 1, "mp": 1},
                                devices=jax.devices()[:2])
        opt = paddle.optimizer.AdamW(
            learning_rate=1e-2,
            apply_decay_param_fun=lambda n: "ln" not in n)
        step, shard_params, init_state = JG.build_hybrid_train_step(
            CFG, mesh, opt, telemetry=None,
            comm_overlap=jco.CommOverlapConfig(**co), **case)
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


@pytest.mark.parametrize("name", ["overlap", "overlap_z1", "overlap_z3"])
def test_bucketed_overlap_matches_jax(port_runs, name):
    """The bucketed sync over two comm microbatches, at stages 0, 1 and 3,
    against the JAX engine's overlap scan: every loss within 2e-5, the
    gathered parameters within 2e-4, both ranks the same."""
    jl, jp = _jax_gpt(name)
    got = port_runs[0]["gpt"][name]
    np.testing.assert_allclose(got["losses"], jl, rtol=2e-5, atol=2e-5)
    for (n, a), (_, b) in zip(_leaves(got["params"]), _leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-4,
                                   err_msg=n)
    assert port_runs[1]["gpt"][name]["losses"] == got["losses"]


def test_int8_error_feedback_matches_jax(port_runs):
    """The int8 error-feedback path against the JAX engine's, within the
    int8 path's 1e-2 relative, and within 1e-2 of the full-precision
    step; its residuals ride ``state["comm_ef"]``."""
    jl, _ = _jax_gpt("int8")
    got = port_runs[0]["gpt"]["int8"]["losses"]
    rel = np.max(np.abs(np.asarray(got) - jl) / np.abs(jl))
    assert rel <= 1e-2, (got, jl)
    plain = port_runs[0]["gpt"]["plain"]["losses"]
    assert abs(got[-1] - plain[-1]) / abs(plain[-1]) <= 1e-2


def test_int8_overlapped_runs_are_bitwise_deterministic(port_runs):
    """Two identical runs of the overlapped, quantized step: the same bits
    (losses and parameters)."""
    a = port_runs[0]["gpt"]["int8_m2_a"]
    b = port_runs[0]["gpt"]["int8_m2_b"]
    assert a["losses"] == b["losses"]
    for (_, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
        np.testing.assert_array_equal(x, y)


def _jax_mlp(co=None, zero1=False, grd=None, steps=6, lr=0.05):
    params, xs, ys = _mlp_np()
    params = {k: jnp.asarray(v) for k, v in params.items()}
    mesh = jdist.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    specs = {"w": P(), "b": P(), "h": P()}

    def loss_fn(p, x, y):
        h = jnp.tanh(x @ p["w"] + p["b"])
        return jnp.mean((h @ p["h"] - y) ** 2)
    kw = dict(comm_overlap=co, zero1_dp=zero1,
              example_params=jax.eval_shape(lambda: params))
    if grd is not None:
        kw["grad_reduce_dtype"] = grd
    step, shard, init = j_build(loss_fn, specs, mesh,
                                paddle.optimizer.AdamW(learning_rate=lr),
                                **kw)
    p = shard(params)
    st = init(p)
    losses = []
    for _ in range(steps):
        p, st, loss = step(p, st, jnp.asarray(xs), jnp.asarray(ys),
                           jnp.float32(lr))
        losses.append(float(loss))
    return losses, jax.device_get(p)


def test_mlp_bucketed_is_bitwise_the_monolithic_sync(port_runs):
    """The sum of a concatenation is the concatenation of the sums: the
    fp32 bucketed sync reproduces the per-leaf all-reduce bit for bit, and
    so does the ZeRO-1 reduce-scatter issued the same way."""
    mlp = port_runs[0]["mlp"]
    for a, b in (("mono", "bucketed"), ("z1", "z1_overlap")):
        assert mlp[a]["losses"] == mlp[b]["losses"], (a, b)
        for k in mlp[a]["params"]:
            np.testing.assert_array_equal(mlp[a]["params"][k],
                                          mlp[b]["params"][k])


@pytest.mark.parametrize("name", ["mono", "micro2", "z1", "bf16_bucketed"])
def test_mlp_matches_jax(port_runs, name):
    """The MLP through build_train_step against the JAX engine on two
    devices: every loss within 1e-5, the parameters within 1e-4 / 1e-5."""
    co = {"mono": None, "z1": None,
          "micro2": jco.CommOverlapConfig(bucket_mb=1e-4, microbatches=2),
          "bf16_bucketed": jco.CommOverlapConfig(
              bucket_mb=1e-4, reduce_dtype=jnp.bfloat16)}[name]
    jl, jp = _jax_mlp(co, zero1=name == "z1")
    got = port_runs[0]["mlp"][name]
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    for k in jp:
        np.testing.assert_allclose(got["params"][k], np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_skips_grad_sync_optimizer_ignores_overlap(port_runs):
    """An optimizer with ``_skips_grad_sync`` owns the dp axis: the engine
    reduces nothing, with or without a CommOverlapConfig (the same bits),
    and each rank trains on its own rows."""
    mlp = [port_runs[r]["mlp"] for r in range(2)]
    assert mlp[0]["skips"]["losses"] == mlp[0]["skips_overlap"]["losses"]
    for k in mlp[0]["skips"]["params"]:
        np.testing.assert_array_equal(mlp[0]["skips"]["params"][k],
                                      mlp[0]["skips_overlap"]["params"][k])
    assert mlp[0]["skips"]["losses"] != mlp[1]["skips"]["losses"]


def test_mlp_reduce_dtype_is_honored(port_runs):
    """CommOverlapConfig.reduce_dtype reaches the wire: the bf16-wire
    bucketed run matches the bf16 monolithic reduction and differs from
    the fp32 one."""
    mlp = port_runs[0]["mlp"]
    np.testing.assert_allclose(mlp["bf16_bucketed"]["losses"],
                               mlp["bf16_mono"]["losses"], rtol=1e-6)
    assert mlp["bf16_bucketed"]["losses"] != mlp["bucketed"]["losses"]
