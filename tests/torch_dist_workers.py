"""Multi-rank jobs for the port's distributed tests, run in spawned child
processes over gloo on the CPU.

This module imports ``torch``, numpy and the port only (never JAX or the
JAX package), so a child process starts without them. ``spawn(job, world,
*args)`` starts ``world`` processes that meet through a ``FileStore`` in a
fresh temporary directory (no port to pick), runs ``job(rank, world,
*args)`` in each, and returns the ranks' results in rank order; a child's
exception is raised in the parent with its traceback. ``device="cuda"``
runs the ranks over NCCL on the card instead of gloo.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch

_CHILD_THREADS = 2


def _child(job, rank, world, store_path, out_path, args, device):
    torch.set_num_threads(_CHILD_THREADS)
    try:
        from paddle_tpu_torch.distributed import init_parallel_env
        init_parallel_env(rank=rank, world_size=world,
                          init_method=f"file://{store_path}", device=device)
        result = ("ok", job(rank, world, *args))
    except BaseException:  # noqa: BLE001 - reported to the parent
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    try:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        pass


def spawn(job, world, *args, timeout=600, device="cpu"):
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        outs = [os.path.join(d, f"out{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_child,
                             args=(job, r, world, store, outs[r], args,
                                   device))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {world} left no result "
                                   f"(exit code {procs[r].exitcode})")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results.append(value)
    return results


def run_many(rank, world, jobs):
    """Several jobs in one spawn: ``[(name, job, args), ...]`` ->
    ``{name: job(rank, world, *args)}``."""
    return {name: job(rank, world, *args) for name, job, args in jobs}


# ---------------------------------------------------------------------------
# the collectives, on per-rank inputs drawn from a seed
# ---------------------------------------------------------------------------
def rank_inputs(world, seed=0):
    """Rank-major inputs: ``x[r]`` is rank r's tensor of each case."""
    rng = np.random.RandomState(seed)
    return {
        "x": rng.randn(world, 4 * world, 3).astype(np.float32),
        "pos": (rng.rand(world, 5).astype(np.float32) + 0.5),
        "mat": rng.randn(world, world, 6).astype(np.float32),
    }


def collectives_job(rank, world, seed):
    from paddle_tpu_torch.distributed import collective as C
    inp = rank_inputs(world, seed)
    x = torch.from_numpy(inp["x"][rank].copy())
    pos = torch.from_numpy(inp["pos"][rank].copy())
    mat = torch.from_numpy(inp["mat"][rank].copy())
    out = {}
    for op in ("sum", "max", "min", "avg"):
        out[f"all_reduce_{op}"] = C.all_reduce(x.clone(), op).numpy()
    out["all_reduce_prod"] = C.all_reduce(pos.clone(), "prod").numpy()
    w = C.all_reduce(x.clone(), "avg", sync_op=False)
    out["all_reduce_avg_async"] = w.wait().numpy()
    out["all_gather"] = C.all_gather(x).numpy()
    out["all_gather_tiled1"] = C.all_gather(x, gather_axis=1,
                                            tiled=True).numpy()
    lst = []
    C.all_gather(lst, x)
    out["all_gather_list"] = np.stack([t.numpy() for t in lst])
    out["reduce_scatter"] = C.reduce_scatter(x).numpy()
    out["reduce_scatter_dim1"] = C.reduce_scatter(
        x.reshape(world, 4, 3).permute(1, 0, 2).contiguous(),
        scatter_dim=1).numpy()
    src = world - 1
    out["broadcast"] = C.broadcast(x.clone(), src=src).numpy()
    red = C.reduce(x.clone(), dst=0)
    out["reduce"] = red.numpy()
    out["scatter"] = C.scatter(mat, src=0).numpy()
    tgt = torch.empty(6)
    C.scatter(tgt, list(mat.unbind(0)), src=0)
    out["scatter_list"] = tgt.numpy()
    out["all_to_all"] = C.all_to_all(x).numpy()
    out["all_to_all_split1"] = C.all_to_all(
        x.reshape(world, 4, 3).permute(1, 0, 2).contiguous(), split_axis=1,
        concat_axis=0).numpy()
    ring = [(i, (i + 1) % world) for i in range(world)]
    out["ppermute_ring"] = C.ppermute(x, ring).numpy()
    out["ppermute_partial"] = C.ppermute(x, [(0, world - 1)]).numpy()
    peer_send, peer_recv = (rank + 1) % world, (rank - 1) % world
    got = torch.empty_like(x)
    for work in C.batch_isend_irecv([C.P2POp("isend", x, peer_send),
                                     C.P2POp("irecv", got, peer_recv)]):
        work.wait()
    out["batch_isend_irecv"] = got.numpy()
    if rank == 0:
        C.send(x, 1)
    elif rank == 1:
        buf = torch.empty_like(x)
        C.recv(buf, 0)
        out["send_recv"] = buf.numpy()
    g = C.new_group(list(range(world)))
    out["group_ranks"] = (g.rank, g.nranks, C.get_group(g.id) is g)
    out["new_group_all_reduce"] = C.all_reduce(x.clone(), group=g).numpy()
    C.barrier()
    return out


def zero3_job(rank, world, seed):
    """The ZeRO-3 gather primitives on rank r's shard (row r of
    ``rank_inputs``' "x", 4 rows of 3): the gather along dims 0 and 1, its
    gradient (each rank weighs the full leaf by (rank + 1) w), a group of
    two leaves, ``gather_tree`` on stacked shards, and the int8
    error-feedback gather with its residual."""
    from paddle_tpu_torch.distributed.comm_overlap import zero3 as Z3
    inp = rank_inputs(world, seed)
    x = torch.from_numpy(inp["x"][rank][:4].copy())
    res = torch.from_numpy(inp["x"][rank][4:8].copy() * 0.01)
    out = {}
    for dim in (0, 1):
        xs = x.clone().requires_grad_(True)
        full = Z3.all_gather_param(xs, dim, None)
        w = torch.arange(full.numel(), dtype=torch.float32).view(full.shape)
        (full * w * (rank + 1)).sum().backward()
        out[f"gather{dim}"] = full.detach().numpy()
        out[f"grad{dim}"] = xs.grad.numpy()
    a = x.clone().requires_grad_(True)
    b = (x[:, :2] * 2).clone().requires_grad_(True)
    fa, fb = Z3.gather_group([a, b], [0, 1], None)
    (fa.sum() + 3 * fb.sum()).backward()
    out["group"] = (fa.detach().numpy(), fb.detach().numpy(),
                    a.grad.numpy(), b.grad.numpy())
    stacked = {"w": x.reshape(2, 2, 3), "b": torch.ones(2, 5)}
    layer = Z3.gather_tree({k: v[1] for k, v in stacked.items()},
                           {"w": 1, "b": -1}, None)
    out["tree"] = (layer["w"].numpy(), layer["b"].numpy())
    full, new_res = Z3.ef_quantized_all_gather(x, res, 1, None)
    out["quantized"] = (full.numpy(), new_res.numpy())
    return out


def topology_job(rank, world):
    from paddle_tpu_torch import distributed as D
    mesh = D.build_mesh({"dp": world, "pp": 1, "mp": 1})
    hcg = D.HybridCommunicateGroup(D.CommunicateTopology(
        ("data", "pipe", "model"), (world, 1, 1)))
    D.set_hybrid_communicate_group(hcg)
    batch = torch.arange(4 * world * 2).reshape(4 * world, 2)
    x = torch.full((3,), float(rank + 1))
    s = D.all_reduce(x.clone(), group=mesh.group("dp"))
    env = D.ParallelEnv()
    # DataParallel: the module sees this rank's rows, the gradients come
    # back averaged over the ranks
    lin = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(0.5)
    dp_mod = D.DataParallel(lin)
    xb = torch.arange(8 * world, dtype=torch.float32).reshape(4 * world, 2)
    dp_mod(xb).sum().backward()
    grad = lin.weight.grad.clone()
    lin.weight.grad = None
    with dp_mod.no_sync():
        dp_mod(xb).sum().backward()
    return dict(shape=dict(mesh.shape), coords=dict(mesh.coords),
                dp_group=(mesh.group("dp").rank, mesh.group("dp").ranks),
                pp_group=mesh.group("pp").ranks,
                shard=D.shard_batch(batch, mesh).numpy(),
                hcg=(hcg.get_data_parallel_rank(),
                     hcg.get_data_parallel_world_size(),
                     hcg.get_parallel_mode(),
                     hcg.get_model_parallel_world_size()),
                all_reduce=s.numpy(), env=(env.rank, env.world_size),
                dp_grad=grad.numpy(), local_grad=lin.weight.grad.numpy())


# ---------------------------------------------------------------------------
# the engine: the tiny GPT of tests/test_zero_stages.py and the MLP of
# tests/test_comm_overlap.py
# ---------------------------------------------------------------------------
def _opt(lr, clip):
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    return AdamW(learning_rate=lr,
                 grad_clip=ClipGradByGlobalNorm(0.05) if clip else None,
                 apply_decay_param_fun=lambda n: "ln" not in n)


def _overlap(co):
    if co is None:
        return None
    from paddle_tpu_torch.distributed.comm_overlap import CommOverlapConfig
    return CommOverlapConfig(**co)


def _zero3(z3):
    if z3 is None:
        return "auto"
    from paddle_tpu_torch.distributed.comm_overlap import Zero3Config
    return Zero3Config(**z3)


def _gathered(params, init_state, mesh):
    """The full parameters, gathered over dp where they are shards."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed._tree import flatten, unflatten
    zd = init_state.zdims
    stage3 = init_state.zero_stage >= 3
    out = []
    zl = dict(flatten(zd)) if zd is not None else {}
    for path, p in flatten(params):
        z = zl.get(path, -1)
        if stage3 and z >= 0:
            p = C.all_gather_into(p, z, mesh.group("dp"))
        out.append(p.detach().cpu().numpy().copy())
    return unflatten([p for p, _ in flatten(params)], out)


def gpt_cfg():
    from paddle_tpu_torch.models import gpt as G
    return G.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                       num_heads=4, max_seq_len=16, dtype=torch.float32)


def gpt_job(rank, world, params_np, tokens, labels, cases):
    """Each case: ``{"steps", "lr", "clip", and build_hybrid_train_step's
    keywords}`` -> (losses, gathered final params, extra facts)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import comm_overlap as co
    from paddle_tpu_torch.models import gpt as G
    mesh = D.build_mesh({"dp": world, "pp": 1, "mp": 1})
    cfg = gpt_cfg()
    results = {}
    for name, case in cases.items():
        case = dict(case)
        steps = case.pop("steps", 4)
        lr = case.pop("lr", 1e-2)
        clip = case.pop("clip", False)
        case["comm_overlap"] = _overlap(case.get("comm_overlap"))
        case["zero3"] = _zero3(case.get("zero3"))
        opt = _opt(lr, clip)
        step, shard_params, init_state = G.build_hybrid_train_step(
            cfg, mesh, opt, donate=True, **case)
        p = shard_params(params_np)
        s = init_state(p)
        co.zero3.GATHERS.update(all_gather=0, reduce_scatter=0)
        losses = []
        for _ in range(steps):
            p, s, loss = step(p, s, tokens, labels, lr)
            losses.append(float(loss))
        inner = s.get("opt", s)
        slot = inner["slots"]["blocks"]["qkv_w"]["moment1"]
        results[name] = dict(
            losses=losses, params=_gathered(p, init_state, mesh),
            qkv_w_local=tuple(p["blocks"]["qkv_w"].shape),
            moment1_local=tuple(slot.shape),
            gathers=dict(co.zero3.GATHERS),
            zero3_ef=({k: v.shape for k, v in s["zero3_ef"].items()}
                      if "zero3_ef" in s else None),
            ef_abs=(float(sum(v.abs().sum().item()
                              for v in s["zero3_ef"].values()))
                    if "zero3_ef" in s else None))
    return results


def gpt_moe_cfg(capacity_factor=8.0):
    """tests/test_moe_hybrid.py's CFG: fp32, vocab 64, H 32, 4 layers, 4
    heads, seq 16, E 4."""
    from paddle_tpu_torch.models import gpt as G
    return G.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                       num_heads=4, max_seq_len=16, dtype=torch.float32,
                       moe_num_experts=4,
                       moe_capacity_factor=capacity_factor,
                       moe_aux_weight=1e-2)


def gpt_moe_job(rank, world, params_np, tokens, labels, cases):
    """GPT-MoE through ``build_hybrid_train_step`` on {"dp": world, "ep": 1,
    "pp": 1, "mp": 1}, AdamW at lr 1e-2. Each case: ``{"steps", "cf",
    "index", "eps" (Adam's epsilon), and build_hybrid_train_step's
    keywords}`` -> (losses, final parameters, the last step's MOE_RECORD,
    the local shape of w1's first moment)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.comm_overlap import MoeDispatchConfig
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    mesh = D.build_mesh({"dp": world, "ep": 1, "pp": 1, "mp": 1})
    results = {}
    for name, case in cases.items():
        case = dict(case)
        steps = case.pop("steps", 4)
        cfg = gpt_moe_cfg(case.pop("cf", 8.0))
        dispatch = (MoeDispatchConfig(index=True) if case.pop("index", False)
                    else None)
        opt = AdamW(learning_rate=1e-2, epsilon=case.pop("eps", 1e-8))
        step, shard_params, init_state = G.build_hybrid_train_step(
            cfg, mesh, opt, moe_dispatch=dispatch, donate=True, **case)
        p = shard_params(params_np)
        s = init_state(p)
        losses = []
        for _ in range(steps):
            p, s, loss = step(p, s, tokens, labels, 1e-2)
            losses.append(float(loss))
        slot = s["slots"]["blocks"]["moe"]["w1"]["moment1"]
        results[name] = dict(
            losses=losses, params=_numpy_tree(p),
            drop_frac=float(G.MOE_RECORD["drop_frac"]),
            tokens=G.MOE_RECORD["tokens"].cpu().numpy().copy(),
            w1_moment1_local=tuple(slot.shape))
    return results


def mlp_job(rank, world, job_np, cases):
    """The MLP of tests/test_comm_overlap.py through build_train_step."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.models.hybrid_engine import build_train_step
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    mesh = D.build_mesh({"dp": world})
    params_np, xs, ys = job_np
    specs = {"w": (), "b": (), "h": ()}
    example = {k: torch.empty(v.shape, device="meta")
               for k, v in params_np.items()}

    def loss_fn(p, x, y):
        h = torch.tanh(x @ p["w"] + p["b"])
        return torch.mean((h @ p["h"] - y) ** 2)

    results = {}
    for name, case in cases.items():
        case = dict(case)
        steps = case.pop("steps", 6)
        lr = case.pop("lr", 0.05)
        case["comm_overlap"] = _overlap(case.get("comm_overlap"))
        opt = AdamW(learning_rate=lr)
        if case.pop("skips_grad_sync", False):
            # an optimizer that owns the dp axis (LocalSGD's contract):
            # the engine hands it this rank's unreduced gradients
            opt._skips_grad_sync = True
        step, shard, init = build_train_step(
            loss_fn, specs, mesh, opt, example_params=example, **case)
        p = shard(params_np)
        st = init(p)
        losses = []
        for _ in range(steps):
            p, st, loss = step(p, st, xs, ys, lr)
            losses.append(float(loss))
        res = None
        if isinstance(st, dict) and "comm_ef" in st:
            res = [r.numpy().copy() for r in st["comm_ef"]]
        results[name] = dict(losses=losses,
                             params={k: v.numpy().copy()
                                     for k, v in p.items()},
                             comm_ef=res)
    return results


def quantized_psum_job(rank, world, xs, res):
    """One bucket's int8 error-feedback all-reduce, and the replication-
    aware norm of the new residuals (sharded over every rank)."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.comm_overlap import (ef_quantized_psum,
                                                           residual_sq_norm)
    mesh = D.build_mesh({"dp": world})
    red, new_r = ef_quantized_psum(torch.from_numpy(xs[rank].copy()),
                                   torch.from_numpy(res[rank].copy()), None,
                                   mean_divisor=float(world))
    sq = residual_sq_norm([new_r], [(("dp",),)], mesh)
    return red.numpy(), new_r.numpy(), float(sq)


# ---------------------------------------------------------------------------
# distributed.sharding: the MLP job of tests/test_group_sharded.py
# ---------------------------------------------------------------------------
def group_sharded_mlp_loss(p, x, y):
    """``tests/test_group_sharded.py``'s ``loss_fn`` in torch."""
    h = torch.tanh(x @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(logp.gather(1, y[:, None])[:, 0])


def _numpy_tree(tree):
    from paddle_tpu_torch.distributed._tree import flatten, unflatten
    pairs = flatten(tree)
    return unflatten([p for p, _ in pairs],
                     [t.detach().cpu().numpy().copy()
                      if isinstance(t, torch.Tensor) else t
                      for _, t in pairs])


def group_sharded_job(rank, world, dims, params_np, batches, cases,
                      save_dir=None):
    """Each case: ``{"level", "lr", "offload", "microbatches", "clip"}``
    through ``build_sharded_train_step`` on ``build_mesh(dims)`` ->
    (global losses, gathered final params, this rank's slot shards).
    ``save_dir``: also the ``group_sharded_parallel`` / ``shard_optimizer``
    surface and ``save_group_sharded_model`` into it."""
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.sharding import (
        build_sharded_train_step, gather_sharded)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    mesh = D.build_mesh(dims)
    results = {}
    for name, case in cases.items():
        lr = case.get("lr", 0.1)
        opt = AdamW(learning_rate=lr, grad_clip=(
            ClipGradByGlobalNorm(case["clip"]) if case.get("clip") else None))
        _, place, compile_for = build_sharded_train_step(
            group_sharded_mlp_loss, opt, mesh, level=case["level"],
            offload=case.get("offload", False),
            microbatches=case.get("microbatches", 1))
        p, s = place(params_np)
        step, spec = compile_for(p)
        losses = []
        for x, y in batches:
            xb, yb = (D.shard_batch(torch.from_numpy(a), mesh, spec[0])
                      for a in (x, y))
            p, s, loss = step(p, s, xb, yb, lr)
            losses.append(float(loss))
        full = gather_sharded(p, params_np, mesh, "sharding")
        from paddle_tpu_torch.distributed._tree import flatten
        host = [t for _, t in flatten(s["slots"])
                if t.device.type == "cpu"]
        results[name] = dict(
            losses=losses, params=_numpy_tree(full),
            slots=_numpy_tree(s["slots"]), step=s["step"],
            local_shapes={k: tuple(v.shape) for k, v in p.items()},
            param_device=str(next(iter(p.values())).device),
            host_slot_leaves=len(host),
            host_slots_pinned=all(t.is_pinned() for t in host))
    if save_dir is not None:
        results["surface"] = _group_sharded_surface(rank, mesh, params_np,
                                                    batches, save_dir)
    return results


def _group_sharded_surface(rank, mesh, params_np, batches, save_dir):
    """``group_sharded_parallel`` -> sharded slots, a few ZeRO-1 applies
    over full gradients, then ``save_group_sharded_model``."""
    from paddle_tpu_torch.distributed import sharding as S
    from paddle_tpu_torch.distributed.auto_parallel import (ShardingStage2,
                                                            shard_optimizer)
    from paddle_tpu_torch.distributed.comm_overlap.overlap import \
        value_and_grad
    from paddle_tpu_torch.optimizer.optimizer import AdamW

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in params_np.items():
                self.register_parameter(k, torch.nn.Parameter(
                    torch.from_numpy(v.copy()), requires_grad=False))

    model = Model()
    model, opt, _ = S.group_sharded_parallel(
        model, AdamW(0.05), "os", mesh=mesh, shard_axis="sharding")
    params = {k: v.data for k, v in model.named_parameters()}
    state = opt.init_state(params)
    shapes = {k: tuple(v["moment1"].shape) for k, v in state["slots"].items()}
    losses = []
    for x, y in batches:
        loss, g = value_and_grad(group_sharded_mlp_loss, params,
                                 torch.from_numpy(x), torch.from_numpy(y))
        opt.apply(params, g, state, 0.05)
        losses.append(float(loss))
    full = opt._full_state(state)
    S.save_group_sharded_model(model, save_dir, optimizer=opt,
                               opt_state=state)
    off = shard_optimizer(AdamW(0.05), ShardingStage2(mesh, "sharding"),
                          offload=True)
    off_state = off.init_state(params)
    return dict(moment1_shapes=shapes, losses=losses,
                params=_numpy_tree(params), state=_numpy_tree(full),
                offload_slot_types=sorted({type(v).__name__ for v in
                                           off_state["slots"].values()}),
                offload_moment1_shapes={
                    k: tuple(v["moment1"].shape)
                    for k, v in off_state["slots"].items()})
