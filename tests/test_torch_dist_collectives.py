"""The port's process environment, topology, collectives and store
(``paddle_tpu_torch/distributed``: ``env``, ``topology``, ``collective``,
``parallel``, ``store``) against the JAX package's.

The collectives run at world 2 and 4, one spawn each, in child processes
over gloo (``torch_dist_workers``): rank r's input is row r of a rank-major
array drawn from a seed, and its result is held against row r of the JAX
package's eager collective (``collective.py``) over a group of the first n
virtual devices. Sums of floats are held to 1e-6 (gloo and XLA add in
other orders), everything else bit for bit; PROD to 1e-5 (the JAX package
takes it as exp of a sum of logs). The topology, ``shard_batch`` and
``DataParallel`` run in the same spawns; the store and the environment's
refusals run here, on 127.0.0.1 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu.distributed as jdist

import torch
import torch_dist_workers as W
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import store as tstore

SEED = 3


@pytest.fixture(scope="module")
def runs():
    out = {}
    for world in (2, 4):
        out[world] = W.spawn(W.run_many, world, [
            ("coll", W.collectives_job, (SEED,)),
            ("topo", W.topology_job, ()),
            ("zero3", W.zero3_job, (SEED,))])
    return out


def _jax(world):
    g = jdist.new_group(list(range(world)))
    inp = W.rank_inputs(world, SEED)
    x = jnp.asarray(inp["x"])
    res = {
        "all_reduce_sum": jdist.all_reduce(x, "sum", group=g),
        "all_reduce_max": jdist.all_reduce(x, "max", group=g),
        "all_reduce_min": jdist.all_reduce(x, "min", group=g),
        "all_reduce_avg": jdist.all_reduce(x, "avg", group=g),
        "all_reduce_prod": jdist.all_reduce(jnp.asarray(inp["pos"]), "prod",
                                            group=g),
        "all_gather": jdist.all_gather(x, group=g),
        "reduce_scatter": jdist.reduce_scatter(x, group=g),
        "broadcast": jdist.broadcast(x, src=world - 1, group=g),
        "reduce": jdist.reduce(x, dst=0, group=g),
        "scatter": jdist.scatter(jnp.asarray(inp["mat"]), src=0, group=g),
        "all_to_all": jdist.all_to_all(x, group=g),
        "ppermute_ring": jdist.ppermute(
            x, [(i, (i + 1) % world) for i in range(world)], group=g),
        "ppermute_partial": jdist.ppermute(x, [(0, world - 1)], group=g),
    }
    return {k: np.asarray(v) for k, v in res.items()}


EXACT = ("all_reduce_max", "all_reduce_min", "all_gather", "broadcast",
         "scatter", "all_to_all", "ppermute_ring", "ppermute_partial")
SUMS = ("all_reduce_sum", "all_reduce_avg", "reduce_scatter")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", EXACT + SUMS + ("all_reduce_prod",
                                                 "reduce"))
def test_collective_matches_jax_eager(runs, world, name):
    want = _jax(world)[name]
    for r in range(world):
        if name == "reduce" and r != 0:
            continue        # only the destination's result is defined
        got = runs[world][r]["coll"][name]
        if name in EXACT:
            np.testing.assert_array_equal(got, want[r], err_msg=name)
        elif name == "all_reduce_prod":
            np.testing.assert_allclose(got, want[r], rtol=1e-5)
        else:
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("world", [2, 4])
def test_collective_forms_the_jax_package_has_no_eager_twin_of(runs, world):
    """The tiled gather along dim 1, the list forms, the reduce-scatter
    along dim 1, the split-axis all-to-all, batched isend / irecv and
    send / recv, async AVG, a new group: each against numpy on the same
    per-rank inputs."""
    inp = W.rank_inputs(world, SEED)
    x = inp["x"]
    total = x.sum(0)
    for r in range(world):
        got = runs[world][r]["coll"]
        np.testing.assert_array_equal(got["all_gather_tiled1"],
                                      np.concatenate(list(x), axis=1))
        np.testing.assert_array_equal(got["all_gather_list"], x)
        np.testing.assert_array_equal(got["scatter_list"],
                                      inp["mat"][0][r])
        # each rank's [4, world, 3] view: block r along dim 1 is rows
        # [4 r, 4 r + 4) of its x
        rows = x.reshape(world, world, 4, 3)            # [rank, block, 4, 3]
        np.testing.assert_allclose(got["reduce_scatter_dim1"],
                                   rows.sum(0)[r][:, None], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(
            got["all_to_all_split1"],
            np.concatenate([rows[s][r][:, None] for s in range(world)]))
        np.testing.assert_array_equal(got["batch_isend_irecv"],
                                      x[(r - 1) % world])
        np.testing.assert_allclose(got["all_reduce_avg_async"],
                                   total / world, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["new_group_all_reduce"], total,
                                   rtol=1e-6, atol=1e-6)
        assert got["group_ranks"] == (r, world, True)
    np.testing.assert_array_equal(runs[world][1]["coll"]["send_recv"], x[0])


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_groups_shard_batch_and_data_parallel(runs, world):
    """build_mesh over the world: dp holds every rank, the degree-1 axes
    one; shard_batch gives rank r rows [r b/n, (r+1) b/n); the HCG reads
    dp; DataParallel runs the module on this rank's rows and averages the
    gradients over dp, and leaves them local under no_sync."""
    batch = np.arange(4 * world * 2).reshape(4 * world, 2)
    xb = np.arange(8 * world, dtype=np.float32).reshape(4 * world, 2)
    for r in range(world):
        t = runs[world][r]["topo"]
        assert t["shape"] == {"dp": world, "pp": 1, "mp": 1}
        assert t["coords"] == {"dp": r, "pp": 0, "mp": 0}
        assert t["dp_group"] == (r, list(range(world)))
        assert t["pp_group"] == [r]
        np.testing.assert_array_equal(t["shard"], batch[4 * r:4 * r + 4])
        assert t["hcg"] == (r, world, "data_parallel", 1)
        assert t["env"] == (r, world)
        np.testing.assert_array_equal(
            t["all_reduce"], np.full(3, world * (world + 1) / 2))
        # the gradient of sum(x @ w) is the sum of the rows
        np.testing.assert_allclose(t["dp_grad"][0],
                                   xb.sum(0) / world, rtol=1e-6)
        np.testing.assert_allclose(t["local_grad"][0],
                                   xb[4 * r:4 * r + 4].sum(0), rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_zero3_gather_primitives(runs, world):
    """all_gather_param gathers rank r's shard into rows (or columns) r of
    the full leaf, and its backward delivers each rank the group's SUM of
    the full gradient's block r (the transpose of ``lax.all_gather``); a
    group of leaves gathers and reduce-scatters the same in one collective
    each way; gather_tree gathers a stacked slice along dim zd - 1; the
    int8 error-feedback gather equals the JAX package's under shard_map
    bit for bit, full leaf and residual."""
    inp = W.rank_inputs(world, SEED)
    xs = inp["x"][:, :4]                                  # [n, 4, 3]
    res = inp["x"][:, 4:8] * np.float32(0.01)
    tot = world * (world + 1) / 2
    for r in range(world):
        z = runs[world][r]["zero3"]
        for dim in (0, 1):
            full = np.concatenate(list(xs), axis=dim)
            np.testing.assert_array_equal(z[f"gather{dim}"], full)
            w = np.arange(full.size, dtype=np.float32).reshape(full.shape)
            blk = np.split(w * tot, world, axis=dim)[r]
            np.testing.assert_allclose(z[f"grad{dim}"], blk, rtol=1e-6)
        fa, fb, ga, gb = z["group"]
        np.testing.assert_array_equal(fa, np.concatenate(list(xs), 0))
        np.testing.assert_array_equal(
            fb, np.concatenate(list(xs[:, :, :2] * 2), 1))
        np.testing.assert_allclose(ga, np.full((4, 3), world), rtol=0)
        np.testing.assert_allclose(gb, np.full((4, 2), 3 * world), rtol=0)
        tw, tb = z["tree"]
        np.testing.assert_array_equal(
            tw, np.concatenate([x.reshape(2, 2, 3)[1] for x in xs], 0))
        np.testing.assert_array_equal(tb, np.ones(5))
    # the quantized gather against the JAX primitive
    from paddle_tpu.distributed.comm_overlap.zero3 import \
        ef_quantized_all_gather as j_qag
    from paddle_tpu.utils import shard_map
    from jax.sharding import PartitionSpec as P
    mesh = jdist.build_mesh({"dp": world}, devices=jax.devices()[:world])
    fn = shard_map(lambda x, r: j_qag(x, r, 1, "dp"), mesh=mesh,
                   in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P("dp")))
    jfull, jres = fn(jnp.asarray(xs.reshape(-1, 3)),
                     jnp.asarray(res.reshape(-1, 3)))
    jfull = np.asarray(jfull).reshape(world, 4, 3 * world)
    jres = np.asarray(jres).reshape(world, 4, 3)
    for r in range(world):
        full, new_res = runs[world][r]["zero3"]["quantized"]
        np.testing.assert_array_equal(full, jfull[r])
        np.testing.assert_array_equal(new_res, jres[r])


# ---------------------------------------------------------------------------
# the environment and the store, in this process
# ---------------------------------------------------------------------------
def test_env_reads_the_launcher_names(monkeypatch):
    for n in ("PADDLE_TRAINER_ID", "PADDLE_RANK_IN_NODE", "RANK",
              "PADDLE_TRAINERS_NUM", "WORLD_SIZE", "PADDLE_TRAINER_ENDPOINTS",
              "PADDLE_LOCAL_RANK", "LOCAL_RANK"):
        monkeypatch.delenv(n, raising=False)
    assert (tenv.get_rank(), tenv.get_world_size(),
            tenv.get_local_rank()) == (0, 1, 0)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert (tenv.get_rank(), tenv.get_world_size(),
            tenv.get_local_rank()) == (3, 8, 1)
    monkeypatch.setenv("PADDLE_TRAINER_ID", "5")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2")
    assert (tenv.get_rank(), tenv.get_world_size()) == (5, 2)
    env = tenv.ParallelEnv()
    assert (env.rank, env.nranks, env.dev_id) == (5, 2, 1)


def test_init_parallel_env_refuses_what_it_cannot_start(monkeypatch):
    """No card and no device="cpu": it raises rather than fall back to the
    CPU; more than one rank with no rendezvous: it raises."""
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.delenv("PADDLE_MASTER", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tenv.init_parallel_env(rank=0, world_size=1)
    with pytest.raises(ValueError, match="rendezvous"):
        tenv.init_parallel_env(rank=0, world_size=2, device="cpu")
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        tenv.init_parallel_env(rank=0, world_size=1, backend="nccl",
                               device="cpu")
    assert not tenv.is_initialized()


def test_tcp_store_on_loopback():
    """set / get / add / wait / compare_set / delete_key / num_keys on a
    master at a free port and a second client; a missing key times out as
    StoreTimeout; a one-participant barrier passes."""
    master = tstore.TCPStore("127.0.0.1", 0, world_size=1, is_master=True,
                             timeout=5)
    client = tstore.MasterStore(f"127.0.0.1:{master.port}", 1, 1, timeout=5)
    master.set("k", "v1")
    assert client.get("k") == b"v1"
    assert client.add("n", 3) == 3 and master.add("n", 2) == 5
    client.wait(["k"])
    assert master.compare_set("c", b"", b"x") == b"x"
    assert master.compare_set("c", b"y", b"z") == b"x"
    assert client.num_keys() >= 3
    assert master.delete_key("k") and not master.delete_key("k")
    with pytest.raises(tstore.StoreTimeout):
        client.get("absent", timeout=0.2)
    master.barrier("b")
    master.barrier("b")                 # a new round of the same name


def test_store_retry_backs_off_and_counts(monkeypatch):
    """_with_retry: a transient fault is retried (counted per op) until it
    passes, gives up after FLAGS_store_retry_max attempts, and never
    retries a StoreTimeout."""
    keep = {k: tflags.flag(k) for k in ("store_retry_max",
                                         "store_retry_base_s")}
    tflags.set_flags({"store_retry_max": 3, "store_retry_base_s": 0.001})
    tstore.reset_retry_stats()
    try:
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise tstore.TransientStoreError("dropped")
            return "ok"
        assert tstore._with_retry("get", flaky) == "ok"
        assert tstore.retry_stats() == {"get": 2}

        def always():
            raise tstore.TransientStoreError("down")
        with pytest.raises(tstore.TransientStoreError):
            tstore._with_retry("set", always)
        assert tstore.retry_stats()["set"] == 3

        def timeout():
            calls.append(1)
            raise tstore.StoreTimeout("late")
        n = len(calls)
        with pytest.raises(tstore.StoreTimeout):
            tstore._with_retry("wait", timeout)
        assert len(calls) == n + 1
    finally:
        tflags.set_flags(keep)
        tstore.reset_retry_stats()


def test_unreachable_master_is_a_timeout():
    with pytest.raises(tstore.StoreTimeout):
        tstore.TCPStore("127.0.0.1", 1, world_size=2, is_master=False,
                        timeout=0.3)


def test_hcg_refuses_model_axes():
    from paddle_tpu_torch import distributed as D
    with pytest.raises(NotImplementedError, match="item 6"):
        D.HybridCommunicateGroup(D.CommunicateTopology(
            ("data", "pipe", "model"), (1, 1, 2)))
    topo = D.CommunicateTopology(("data", "model"), (2, 2))
    assert topo.get_comm_list("data") == [[0, 2], [1, 3]]
    assert topo.get_rank(data=1, model=0) == 2
