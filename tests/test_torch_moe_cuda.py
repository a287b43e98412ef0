"""The port's MoE on the card against the port on the CPU: ``MoELayer`` in
index and einsum dispatch (forward and every gradient, fp32; bf16 forward),
``fused_moe``, and the tiny GPT-MoE of ``tests/test_moe_hybrid.py`` through
``build_hybrid_train_step`` at world size 1 over NCCL against the same step
over gloo on the CPU (``torch_dist_workers.gpt_moe_job``, one child process
each): three AdamW steps, dense and index, every loss within 1e-5
relative (the card's flash kernels and GEMMs add in other orders), the
final parameters within 2e-4 (``tests/test_torch_gpt_moe.py``'s tolerance
against the JAX engine, Adam epsilon 1e-6 as there).

Needs a CUDA card; skips without one. Imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_moe_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as W

pytestmark = pytest.mark.cuda

CASES = {
    "dense": dict(num_microbatches=1, steps=3, eps=1e-6),
    "index": dict(num_microbatches=1, steps=3, eps=1e-6, index=True),
    "index_drop_m2": dict(num_microbatches=2, steps=3, eps=1e-6, index=True,
                          cf=1.25),
    "dense_drop_s1": dict(num_microbatches=1, steps=3, eps=1e-6, cf=1.25,
                          zero_stage=1),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _layer(gate, mode, cf, device):
    from paddle_tpu_torch import device_guard
    from paddle_tpu_torch import random as TR
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
    with device_guard(device), TR.rng_guard(
            torch.Generator().manual_seed(3)):
        return MoELayer(64, 128, 8, gate=gate, top_k=2, capacity_factor=cf,
                        dispatch_mode=mode)


@pytest.mark.parametrize("mode", ["index", "einsum"])
@pytest.mark.parametrize("gate,cf", [("switch", 1.25), ("gshard", 2.0),
                                     ("naive", 0.5)])
def test_moe_layer_card_matches_cpu(gate, cf, mode):
    """fp32 forward, aux and the gradients of sum(y^2) + aux (x and every
    parameter) within 1e-4 relative l2 of the CPU's; the bf16 forward
    within 2e-2."""
    _need_card()
    x = torch.from_numpy(np.random.RandomState(0).randn(512, 64)
                         .astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        lay = _layer(gate, mode, cf, dev)
        xd = x.to(dev).requires_grad_(True)
        y, aux = lay(xd, return_aux=True)
        grads = torch.autograd.grad(torch.sum(y ** 2) + aux,
                                    [xd] + list(lay.parameters()))
        yb = lay.to(torch.bfloat16)(x.to(dev, torch.bfloat16))
        out[dev] = [y, aux] + list(grads) + [yb.float()]
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        a, b = a.detach().cpu().double(), b.detach().double()
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        assert rel <= (2e-2 if i == len(out["cpu"]) - 1 else 1e-4), (i, rel)


def test_fused_moe_card_matches_cpu():
    _need_card()
    from paddle_tpu_torch.incubate.nn.functional import fused_moe
    rng = np.random.RandomState(1)
    args = [rng.randn(512, 64), rng.randn(64, 8), rng.randn(8, 64, 128) * 0.1,
            rng.randn(8, 128) * 0.1, rng.randn(8, 128, 64) * 0.1,
            rng.randn(8, 64) * 0.1]
    res = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.from_numpy(a.astype(np.float32)).to(dev)
              .requires_grad_(True) for a in args]
        o, p = fused_moe(*ts, top_k=2)
        g = torch.autograd.grad(torch.sum(o ** 2), ts)
        res[dev] = [o, p] + list(g)
    for a, b in zip(res["cuda"], res["cpu"]):
        a, b = a.detach().cpu().double(), b.detach().double()
        assert ((a - b).norm() / b.norm()).item() <= 1e-4


@pytest.fixture(scope="module")
def runs():
    _need_card()
    from paddle_tpu_torch.models import gpt as G
    params = G.init_hybrid_params(W.gpt_moe_cfg(), 0, "cpu")
    params = W._numpy_tree(params)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (8, 16))
    labels = rng.randint(0, 64, (8, 16))
    card = W.spawn(W.gpt_moe_job, 1, params, tokens, labels, CASES,
                   device="cuda")[0]
    cpu = W.spawn(W.gpt_moe_job, 1, params, tokens, labels, CASES)[0]
    return card, cpu


@pytest.mark.parametrize("name", sorted(CASES))
def test_gpt_moe_card_matches_cpu(runs, name):
    card, cpu = runs
    a, b = card[name], cpu[name]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5,
                               err_msg=name)
    assert a["drop_frac"] == b["drop_frac"], name
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    from paddle_tpu_torch.distributed._tree import flatten
    for (path, x), (_, y) in zip(flatten(a["params"]), flatten(b["params"])):
        np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{name}: {path}")
