"""The offload tiers on the card against the same runs on the CPU.

* The parameter-streaming trainer (``distributed/sharding/param_stream.py``)
  on ``gpt_tiny`` in fp32, 3 AdamW steps from one tree (and with
  ``ClipGradByGlobalNorm``): every loss within 1e-5 relative of the CPU
  run's (the card's flash kernels and GEMMs add in other orders), the final
  parameters within 2e-4; every host leaf of the parameters and the state
  is pinned, and the flash and fused Adam kernels launched as the streamed
  step says (2 L forward, L dQ, L dK/dV; 3 L, 2 L, 2 L with the global-norm
  clip; one fused Adam launch per eligible leaf).
* ``build_sharded_train_step`` at world size 1 over NCCL, levels os, os_g
  and p_g_os with and without offload, against gloo on the CPU
  (``tests/test_group_sharded.py``'s MLP, through ``torch_dist_workers``):
  losses within 1e-5 relative, parameters within 2e-4, the parked slots
  pinned, offload and no offload bit for bit alike on the card.
* The fused Adam kernel on a shard (``kernels.fused_adam.shard_window``):
  with bf16 moments and stochastic rounding, each shard's update is bit for
  bit the block of the whole leaf's update, along a leading, a trailing and
  a middle dim.

Needs a CUDA card; skips without one. Imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_param_stream_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as W

pytestmark = pytest.mark.cuda

LEVEL_CASES = {f"{lv}{'_offload' if off else ''}": dict(level=lv, offload=off)
               for lv in ("os", "os_g", "p_g_os") for off in (False, True)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned-memory and NCCL legs run "
                    "there")


def _mlp_job():
    rng = np.random.RandomState(0)
    params = {"w1": (rng.randn(16, 32) * .1).astype(np.float32),
              "b1": np.zeros(32, np.float32),
              "w2": (rng.randn(32, 4) * .1).astype(np.float32),
              "b2": np.zeros(4, np.float32)}
    batches = [(rng.randn(64, 16).astype(np.float32),
                rng.randint(0, 4, (64,))) for _ in range(4)]
    return params, batches


@pytest.fixture(scope="module")
def level_runs():
    _card()
    params, batches = _mlp_job()
    card = W.spawn(W.group_sharded_job, 1, {"sharding": 1}, params, batches,
                   LEVEL_CASES, device="cuda")[0]
    cpu = W.spawn(W.group_sharded_job, 1, {"sharding": 1}, params, batches,
                  LEVEL_CASES)[0]
    return card, cpu


def _leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, prefix + k + ".")
        else:
            out.append((prefix + k, v))
    return out


@pytest.mark.parametrize("name", sorted(LEVEL_CASES))
def test_levels_over_nccl_match_gloo(level_runs, name):
    card, cpu = level_runs
    assert card[name]["param_device"].startswith("cuda")
    np.testing.assert_allclose(card[name]["losses"], cpu[name]["losses"],
                               rtol=1e-5, err_msg=name)
    for (n, a), (_, b) in zip(_leaves(card[name]["params"]),
                              _leaves(cpu[name]["params"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{name}: {n}")
    if name.endswith("_offload"):
        assert card[name]["host_slot_leaves"] == 8
        assert card[name]["host_slots_pinned"]
        base = card[name[:-len("_offload")]]
        assert base["losses"] == card[name]["losses"]
        for (n, a), (_, b) in zip(_leaves(base["slots"]),
                                  _leaves(card[name]["slots"])):
            np.testing.assert_array_equal(a, b, err_msg=n)
    else:
        assert card[name]["host_slot_leaves"] == 0


def _streamed(device, clip=None):
    from paddle_tpu_torch.distributed._tree import flatten
    from paddle_tpu_torch.distributed.sharding import (
        build_param_streamed_train_step)
    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import fused_adam as FAD
    from paddle_tpu_torch.models import gpt as G
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    cfg = G.gpt_tiny(dtype=torch.float32, param_dtype=torch.float32)
    params = G.init_hybrid_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 64)))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 64)))
    opt = AdamW(1e-3, grad_clip=ClipGradByGlobalNorm(0.05) if clip else None)
    place, init_state, step = build_param_streamed_train_step(
        *G.streamed_fns(cfg), opt, device=device)
    hp = place(G.split_streamed_params(params, cfg))
    hs = init_state(hp)
    for fn in (FA.flash_fwd, FA.flash_bwd_dq, FA.flash_bwd_dkv,
               FAD.adam_update):
        fn.LAUNCHES = 0
    losses = []
    for _ in range(3):
        hp, hs, loss = step(hp, hs, tokens, labels, 1e-3)
        losses.append(float(loss))
    launches = dict(fwd=FA.flash_fwd.LAUNCHES, dq=FA.flash_bwd_dq.LAUNCHES,
                    dkv=FA.flash_bwd_dkv.LAUNCHES,
                    adam=FAD.adam_update.LAUNCHES)
    host = [t for _, t in flatten(hp["embed"]) + flatten(hp["head"])
            + flatten(hs["slots"]["embed"]) + flatten(hs["slots"]["head"])]
    for b, s in zip(hp["blocks"], hs["slots"]["blocks"]):
        host += [t for _, t in flatten(b) + flatten(s)]
    params = [t.float().numpy().copy() for t in host]
    return cfg, losses, params, host, launches


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "global_norm"])
def test_streamed_on_the_card_matches_the_cpu(clip):
    _card()
    cfg, card_l, card_p, host, launches = _streamed("cuda", clip)
    _, cpu_l, cpu_p, _, _ = _streamed("cpu", clip)
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-5)
    for a, b in zip(card_p, cpu_p):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    assert host and all(t.device.type == "cpu" and t.is_pinned()
                        for t in host)
    L, steps = cfg.num_layers, 3
    passes = 3 if clip else 2
    assert launches["fwd"] == passes * L * steps, launches
    assert launches["dq"] == (passes - 1) * L * steps, launches
    assert launches["dkv"] == (passes - 1) * L * steps, launches
    # fused Adam: the leaves of >= 65536 elements and ndim >= 2 (gpt_tiny:
    # fc1_w and fc2_w of each block, wte and head_w)
    assert launches["adam"] == (2 * L + 2) * steps, launches


# (shape, shard dim, shards), every shard >= 65536 elements (the kernel's
# gate): a leading dim, a trailing one (inner 1), middle dims with an inner
# size that is (256) and is not (820) a multiple of 8
KERNEL_SHARD_CASES = [((1024, 512), 0, 2), ((256, 1024), 1, 4),
                      ((16, 96, 256), 1, 2), ((8, 40, 820), 1, 4)]


@pytest.mark.parametrize("shape,dim,n", KERNEL_SHARD_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_kernel_shard_update_rounds_as_the_whole_leaf(shape, dim, n):
    _card()
    from paddle_tpu_torch.kernels import fused_adam as FAD
    from paddle_tpu_torch.optimizer.optimizer import AdamW
    gen = torch.Generator(device="cuda").manual_seed(1)
    p0 = torch.randn(shape, device="cuda", generator=gen)
    g = torch.randn(shape, device="cuda", generator=gen)
    opt = AdamW(1e-2, moment_dtype=torch.bfloat16)
    slot0 = opt._init_slot(p0)
    seed = (3, 7)

    def update(p, g, slot, seed):
        p, slot = p.clone(), {k: v.clone() for k, v in slot.items()}
        before = FAD.adam_update.LAUNCHES
        opt._update(p, g, slot, 1e-2, 1, seed=seed)
        assert FAD.adam_update.LAUNCHES == before + 1
        return p, slot

    p_full, s_full = update(p0, g, slot0, seed)
    per = shape[dim] // n
    for idx in range(n):
        def blk(t):
            return t.narrow(dim, idx * per, per).contiguous()
        p, s = update(blk(p0), blk(g), {k: blk(v) for k, v in slot0.items()},
                      FAD.shard_window(seed, dim, idx * per, shape[dim]))
        assert torch.equal(p, blk(p_full))
        for k in s:
            assert torch.equal(s[k], blk(s_full[k])), (idx, k)
