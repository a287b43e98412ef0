"""The port's GroupSharded ZeRO levels (``paddle_tpu_torch/distributed/
sharding/group_sharded.py``, ``auto_parallel/api.py``'s ``shard_optimizer``,
``fleet/meta_parallel/sharding``, ``framework/io.py``) against the JAX
package's ``build_sharded_train_step`` on the virtual CPU mesh.

The ranks run in child processes over gloo (``torch_dist_workers``: one
spawn at world 2, ``{"sharding": 2}``, and one at world 4, ``{"dp": 2,
"sharding": 2}``); the JAX goldens run on a mesh of the same shape over the
first 2 or 4 virtual devices, each once. The job is
``tests/test_group_sharded.py``'s MLP (``init_params``, ``loss_fn``,
``batches_for``, AdamW at lr 0.1, 4 steps) and its tolerances: losses at
rtol 1e-4 / atol 1e-5, final parameters at rtol 1e-3 / atol 5e-5. The two
packages add the data-axes sums and the GEMMs in other orders, so fp32
agrees to ulps, not bits; inside the port, offload and no offload are held
bit for bit (offload only moves bytes).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.sharding import group_sharded as JGS
from paddle_tpu.models import gpt as JG

import torch
import torch_dist_workers as W
from paddle_tpu_torch import enforce as TE
from paddle_tpu_torch.distributed import auto_parallel as TAP
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    DygraphShardingOptimizer, GroupShardedStage3)
from paddle_tpu_torch.distributed.sharding import group_sharded as TGS
from paddle_tpu_torch.framework import io as TIO
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.optimizer.optimizer import AdamW

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-3, atol=5e-5)
MESHES = {2: {"sharding": 2}, 4: {"dp": 2, "sharding": 2}}

# name -> (world, case); the JAX golden takes the same keywords
CASES = {
    **{f"{lv}_w2": (2, dict(level=lv)) for lv in JGS.LEVELS},
    **{f"{lv}_w4": (4, dict(level=lv)) for lv in JGS.LEVELS},
    "os_offload_w2": (2, dict(level="os", offload=True)),
    "p_g_os_offload_w2": (2, dict(level="p_g_os", offload=True)),
    "os_g_micro2_w2": (2, dict(level="os_g", microbatches=2)),
    "p_g_os_clip_w2": (2, dict(level="p_g_os", clip=0.05)),
}


def _params_np():
    return jax.device_get(_jax_init())


def _jax_init():
    from test_group_sharded import init_params
    return init_params(jax.random.PRNGKey(0))


def _batches_np():
    from test_group_sharded import batches_for
    return [tuple(np.asarray(a) for a in b) for b in batches_for()]


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("group_sharded_save"))


@pytest.fixture(scope="module")
def port_runs(save_dir):
    params, batches = _params_np(), _batches_np()
    out = {}
    for world in (2, 4):
        cases = {n: c for n, (w, c) in CASES.items() if w == world}
        ranks = W.spawn(W.group_sharded_job, world, MESHES[world], params,
                        batches, cases, save_dir if world == 2 else None)
        for name in cases:
            out[name] = [r[name] for r in ranks]
        if world == 2:
            out["surface"] = [r["surface"] for r in ranks]
    return out


_JAX = {}


def _jax_run(name):
    if name not in _JAX:
        from test_group_sharded import loss_fn
        world, case = CASES[name]
        case = dict(case)
        clip = case.pop("clip", None)
        mesh = jdist.build_mesh(MESHES[world], devices=jax.devices()[:world])
        opt = paddle.optimizer.AdamW(
            learning_rate=0.1,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(clip) if clip else None)
        _, place, compile_for = JGS.build_sharded_train_step(
            loss_fn, opt, mesh, **case)
        p, s = place(_jax_init())
        step, bspec = compile_for(p)
        losses = []
        for x, y in _batches_np():
            x, y = jax.device_put(x, bspec), jax.device_put(y, bspec)
            p, s, loss = step(p, s, x, y, 0.1)
            losses.append(float(loss))
        _JAX[name] = (losses, jax.device_get(p))
    return _JAX[name]


def _assert_run_matches_jax(name, runs):
    losses, params = _jax_run(name)
    for r, res in enumerate(runs):
        np.testing.assert_allclose(res["losses"], losses, **LOSS_TOL,
                                   err_msg=f"{name} rank {r} losses")
        for k in params:
            np.testing.assert_allclose(res["params"][k],
                                       np.asarray(params[k]), **PARAM_TOL,
                                       err_msg=f"{name} rank {r} {k}")
    # every rank holds the same global loss and the same gathered tree
    for res in runs[1:]:
        assert res["losses"] == runs[0]["losses"]
        for k in params:
            np.testing.assert_array_equal(res["params"][k],
                                          runs[0]["params"][k])


def _leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + k + ".")
        else:
            out.append((prefix + k, v))
    return out


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------
def _shape_trees():
    mlp = {k: np.zeros(v.shape, np.float32) for k, v in
           _jax_init().items()}
    gpt = jax.device_get(JG.init_hybrid_params(
        JG.gpt_tiny(dtype=jnp.float32), jax.random.PRNGKey(0)))
    odd = {"a": np.zeros((3, 5)), "b": np.zeros((8, 5)), "c": np.zeros((7,)),
           "d": np.zeros((6, 6, 10)), "e": np.zeros((4, 16)),
           "f": np.zeros(()), "g": np.zeros((1, 9)), "h": np.zeros((12, 12))}
    return {"mlp": mlp, "gpt_tiny": gpt, "indivisible": odd}


@pytest.mark.parametrize("size", [1, 2, 4, 8])
@pytest.mark.parametrize("tree", ["mlp", "gpt_tiny", "indivisible"])
def test_shard_spec_and_param_specs_match_jax(tree, size):
    params = _shape_trees()[tree]
    mesh = types.SimpleNamespace(shape={"sharding": size})
    for name, leaf in _leaves(params):
        meta = torch.empty(np.shape(leaf), device="meta")
        got = TGS.shard_spec_for(meta, mesh, "sharding")
        want = tuple(JGS.shard_spec_for(jnp.zeros(np.shape(leaf)), mesh,
                                        "sharding"))
        assert got == want, (name, np.shape(leaf), got, want)
    for stage in (1, 2, 3):
        got = dict(_leaves(TGS.param_specs(params, mesh, "sharding", stage)))
        want = dict(_leaves(jax.tree.map(
            tuple, JGS.param_specs(params, mesh, "sharding", stage),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
        assert got == want, (tree, size, stage)


def test_state_specs_shard_every_slot_like_its_param():
    mesh = types.SimpleNamespace(shape={"sharding": 2})
    params = _shape_trees()["gpt_tiny"]
    specs = TGS._state_specs(AdamW(0.1), params, mesh, "sharding")
    assert specs["step"] == ()
    for name, leaf in _leaves(params):
        want = TGS.shard_spec_for(torch.empty(leaf.shape, device="meta"),
                                  mesh, "sharding")
        slot = specs["slots"]
        for k in name.split("."):
            slot = slot[k]
        assert slot == {"moment1": want, "moment2": want}, name


# ---------------------------------------------------------------------------
# the levels against the JAX step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", [f"{lv}_w{w}" for w in (2, 4)
                                  for lv in JGS.LEVELS])
def test_levels_match_jax(port_runs, name):
    _assert_run_matches_jax(name, port_runs[name])


def test_level_layouts(port_runs):
    """Stage 3 keeps shards at rest (w1 [16, 32] splits its dim 1, the
    largest), stages 1 and 2 full parameters; the slots are shards at
    every level."""
    for w in (2, 4):
        for lv in JGS.LEVELS:
            res = port_runs[f"{lv}_w{w}"][0]
            full = lv != "p_g_os"
            assert res["local_shapes"]["w1"] == ((16, 32) if full
                                                 else (16, 16))
            assert res["local_shapes"]["w2"] == ((32, 4) if full
                                                 else (16, 4))
            assert res["slots"]["w1"]["moment1"].shape == (16, 16)
            assert res["slots"]["b2"]["moment2"].shape == (2,)
            assert res["step"] == 4


@pytest.mark.parametrize("level", ["os", "p_g_os"])
def test_offload_is_bit_identical_and_matches_jax(port_runs, level):
    base = port_runs[f"{level}_w2"]
    off = port_runs[f"{level}_offload_w2"]
    for b, o in zip(base, off):
        assert b["losses"] == o["losses"]
        for (k, x), (_, y) in zip(_leaves(b["params"]), _leaves(o["params"])):
            np.testing.assert_array_equal(x, y, err_msg=k)
        for (k, x), (_, y) in zip(_leaves(b["slots"]), _leaves(o["slots"])):
            np.testing.assert_array_equal(x, y, err_msg=k)
    _assert_run_matches_jax(f"{level}_offload_w2", off)


def test_microbatches_match_jax(port_runs):
    _assert_run_matches_jax("os_g_micro2_w2", port_runs["os_g_micro2_w2"])


def test_global_norm_clip_matches_jax(port_runs):
    # the clip bites: the clipped trajectory leaves the unclipped one
    assert port_runs["p_g_os_clip_w2"][0]["losses"] != \
        port_runs["p_g_os_w2"][0]["losses"]
    _assert_run_matches_jax("p_g_os_clip_w2", port_runs["p_g_os_clip_w2"])


# ---------------------------------------------------------------------------
# the eager surface and the checkpoint
# ---------------------------------------------------------------------------
def test_group_sharded_parallel_gives_sharded_slots(port_runs):
    """``group_sharded_parallel`` / ``shard_optimizer``: slot shards (in
    host Segments with offload), and ZeRO-1 applies over full gradients
    that train as the unsharded AdamW does."""
    from paddle_tpu_torch.distributed.comm_overlap.overlap import \
        value_and_grad
    shards = {"w1": (16, 16), "b1": (16,), "w2": (16, 4), "b2": (2,)}
    for res in port_runs["surface"]:
        assert res["moment1_shapes"] == shards
        assert res["offload_moment1_shapes"] == shards
        assert res["offload_slot_types"] == ["Segment"]
    params = {k: torch.from_numpy(v.copy()) for k, v in _params_np().items()}
    opt = AdamW(0.05)
    state = opt.init_state(params)
    losses = []
    for x, y in _batches_np():
        loss, g = value_and_grad(W.group_sharded_mlp_loss, params,
                                 torch.from_numpy(x), torch.from_numpy(y))
        opt.apply(params, g, state, 0.05)
        losses.append(float(loss))
    for res in port_runs["surface"]:
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(res["params"][k], v.numpy(),
                                       rtol=1e-6, atol=1e-7)
        for k, v in _leaves(state["slots"]):
            got = dict(_leaves(res["state"]["slots"]))[k]
            np.testing.assert_allclose(got, v.numpy(), rtol=1e-6, atol=1e-9)


def test_save_group_sharded_model_loads_in_jax(port_runs, save_dir):
    import os
    surface = port_runs["surface"][0]
    model = paddle.load(os.path.join(save_dir, "model.pdparams"))
    assert sorted(model) == sorted(surface["params"])
    for k, v in surface["params"].items():
        np.testing.assert_array_equal(np.asarray(model[k]), v)
    state = paddle.load(os.path.join(save_dir, "model.pdopt"))
    assert int(state["step"]) == 4
    for (k, x), (_, y) in zip(_leaves(state["slots"]),
                              _leaves(surface["state"]["slots"])):
        assert np.asarray(x).shape == y.shape, k
        np.testing.assert_array_equal(np.asarray(x), y, err_msg=k)
    # and the port's load reads back the same arrays
    mine = TIO.load(os.path.join(save_dir, "model.pdparams"))
    for k, v in surface["params"].items():
        np.testing.assert_array_equal(mine[k], v)


def test_jax_save_loads_in_the_port(tmp_path):
    rng = np.random.RandomState(3)
    tree = {"w": jnp.asarray(rng.randn(4, 6).astype(np.float32)),
            "b": jnp.asarray(rng.randn(6)).astype(jnp.bfloat16),
            "nested": {"step": 7, "l": [jnp.arange(5, dtype=jnp.int32),
                                        np.float32(2.5)]}}
    path = str(tmp_path / "t.pdparams")
    paddle.save(tree, path)
    got = TIO.load(path)
    np.testing.assert_array_equal(got["w"], np.asarray(tree["w"]))
    assert got["b"].dtype == np.asarray(tree["b"]).dtype
    np.testing.assert_array_equal(got["b"], np.asarray(tree["b"]))
    assert got["nested"]["step"] == 7
    np.testing.assert_array_equal(got["nested"]["l"][0], np.arange(5))
    # the port writes bf16 tensors in the same numpy dtype
    t = torch.from_numpy(np.asarray(tree["w"])).to(torch.bfloat16)
    TIO.save({"t": t, "l": [torch.arange(3)]}, str(tmp_path / "p.pd"))
    back = paddle.load(str(tmp_path / "p.pd"))
    np.testing.assert_array_equal(
        np.asarray(back["t"]).astype(np.float32), t.float().numpy())
    assert np.asarray(back["t"]).dtype == np.asarray(tree["b"]).dtype
    np.testing.assert_array_equal(back["l"][0], np.arange(3))


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------
def _fake_mesh(**shape):
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def test_refusals_match_jax():
    from test_group_sharded import loss_fn
    jmesh = jdist.build_mesh({"sharding": 2}, devices=jax.devices()[:2])
    jopt = paddle.optimizer.AdamW(0.1)
    mesh = _fake_mesh(sharding=2)
    # a level that does not exist
    with pytest.raises(ValueError, match="not in allowed set") as mine:
        TGS.build_sharded_train_step(W.group_sharded_mlp_loss, AdamW(0.1),
                                     mesh, level="p_os")
    with pytest.raises(ValueError) as theirs:
        JGS.build_sharded_train_step(loss_fn, jopt, jmesh, level="p_os")
    assert mine.value.args[0] == theirs.value.args[0]
    # offload with scan microbatches
    with pytest.raises(TE.PreconditionNotMetError) as mine:
        TGS.build_sharded_train_step(W.group_sharded_mlp_loss, AdamW(0.1),
                                     mesh, level="os", offload=True,
                                     microbatches=2)
    with pytest.raises(Exception) as theirs:
        JGS.build_sharded_train_step(loss_fn, jopt, jmesh, level="os",
                                     offload=True, microbatches=2)
    assert type(theirs.value).__name__ == "PreconditionNotMetError"
    assert mine.value.args[0] == theirs.value.args[0]
    # a mesh without the shard axis
    with pytest.raises(ValueError, match="mesh has no axis 'sharding'"):
        TGS.build_sharded_train_step(W.group_sharded_mlp_loss, AdamW(0.1),
                                     _fake_mesh(dp=2), level="os")
    with pytest.raises(ValueError, match="not in allowed set"):
        TGS.group_sharded_parallel(None, AdamW(0.1), "zero", mesh=mesh)


def test_item10_parts_raise_naming_it():
    mesh = _fake_mesh(sharding=2)
    opt = AdamW(0.1)
    opt._parameter_list = [object()]
    with pytest.raises(NotImplementedError, match="item 10"):
        TAP.shard_optimizer(opt, TAP.ShardingStage3(mesh, "sharding"))
    with pytest.raises(NotImplementedError, match="item 10"):
        GroupShardedStage3(torch.nn.Linear(2, 2), AdamW(0.1), mesh=mesh)
    dso = DygraphShardingOptimizer(AdamW(0.1), mesh=_fake_mesh(sharding=1))
    with pytest.raises(NotImplementedError, match="item 10"):
        dso.param_to_rank
    for fn in (TAP.shard_tensor, TAP.reshard, TAP.shard_layer,
               TAP.dtensor_from_local, TAP.get_placements):
        with pytest.raises(NotImplementedError, match="item 10"):
            fn()


def test_streamable_gate_and_leaf_names():
    class OwnApply(AdamW):
        def apply(self, params, grads, state, lr=None):
            return super().apply(params, grads, state, lr)

    assert TGS._leaf_streamable(AdamW(1e-3))
    assert TGS._leaf_streamable(
        AdamW(1e-3, apply_decay_param_fun=lambda n: True))
    assert not TGS._leaf_streamable(OwnApply(1e-3))
    assert AdamW(1e-3, apply_decay_param_fun=lambda n: True)._needs_leaf_names
    assert not AdamW(1e-3)._needs_leaf_names
    jax_opt = paddle.optimizer.AdamW(1e-3, apply_decay_param_fun=lambda n:
                                     True)
    assert jax_opt._needs_leaf_names


# (shape, shard dim, shards): a leading dim, a trailing one, and middle dims
# with an inner size that is and is not a multiple of 8 (the kernel's draw
# of eight elements at a time)
SHARD_CASES = [((64, 32), 0, 2), ((16, 64), 1, 4), ((4, 12, 16), 1, 2),
               ((4, 20, 6), 1, 4)]


@pytest.mark.parametrize("shape,dim,n", SHARD_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_shard_update_rounds_as_the_whole_leaf(shape, dim, n):
    """A shard's bf16-moment update under its ``shard_window`` seed is, bit
    for bit, the block of the whole leaf's update: the JAX step rounds the
    global leaf, so the moments must not depend on the number of shards."""
    from paddle_tpu_torch.kernels.fused_adam import shard_window
    rng = np.random.RandomState(1)
    p0 = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    opt = AdamW(1e-2, moment_dtype=torch.bfloat16)
    slot0 = opt._init_slot(p0)
    seed = (3, 7)

    def update(p, g, slot, seed):
        p, slot = p.clone(), {k: v.clone() for k, v in slot.items()}
        opt._update(p, g, slot, 1e-2, 1, seed=seed)
        return p, slot

    p_full, s_full = update(p0, g, slot0, seed)
    _, s_nearest = update(p0, g, slot0, None)
    assert not torch.equal(s_full["moment2"], s_nearest["moment2"])
    per = shape[dim] // n
    for idx in range(n):
        def blk(t):
            return t.narrow(dim, idx * per, per).contiguous()
        p, s = update(blk(p0), blk(g), {k: blk(v) for k, v in slot0.items()},
                      shard_window(seed, dim, idx * per, shape[dim]))
        assert torch.equal(p, blk(p_full))
        for k in s:
            assert torch.equal(s[k], blk(s_full[k])), (idx, k)
