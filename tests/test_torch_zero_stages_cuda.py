"""The ZeRO engine over NCCL on the card against the same engine over gloo
on the CPU: ``tests/test_zero_stages.py``'s tiny fp32 GPT, four AdamW steps
from one init, at world size 1 (one child process each, through
``torch_dist_workers``): stages 0-3, the bucketed sync over two comm
microbatches and the int8 error feedback. Every loss within 1e-5 relative
(the card's flash kernels and GEMMs add in other orders than the CPU's),
the final parameters within 2e-4 (``tests/test_torch_zero_stages.py``'s
tolerance against the JAX engine).

Needs a CUDA card; skips without one. Imports neither JAX nor the JAX
package:

    python -m pytest tests/test_torch_zero_stages_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as W

pytestmark = pytest.mark.cuda

CASES = {
    "s0": dict(num_microbatches=2, zero_stage=0),
    "s1": dict(num_microbatches=2, zero_stage=1),
    "s2": dict(num_microbatches=2, zero_stage=2),
    "s3": dict(num_microbatches=2, zero_stage=3),
    "s3_clip": dict(num_microbatches=2, zero_stage=3, clip=True),
    "overlap_z1": dict(zero_stage=1, comm_overlap=dict(bucket_mb=1e-3,
                                                       microbatches=2)),
    "int8": dict(comm_overlap=dict(bucket_mb=1e-3, quantize="int8")),
}


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NCCL leg runs there")
    from paddle_tpu_torch.models import gpt as G
    params = G.init_hybrid_params(W.gpt_cfg(), 0, "cpu")
    params = {k: ({n: t.numpy() for n, t in v.items()}
                  if isinstance(v, dict) else v.numpy())
              for k, v in params.items()}
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (8, 16))
    labels = rng.randint(0, 64, (8, 16))
    card = W.spawn(W.gpt_job, 1, params, tokens, labels, CASES,
                   device="cuda")[0]
    cpu = W.spawn(W.gpt_job, 1, params, tokens, labels, CASES)[0]
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


@pytest.mark.parametrize("name", sorted(CASES))
def test_nccl_on_the_card_matches_gloo_on_the_cpu(runs, name):
    card, cpu = runs
    np.testing.assert_allclose(card[name]["losses"], cpu[name]["losses"],
                               rtol=1e-5, err_msg=name)
    for (n, a), (_, b) in zip(_leaves(card[name]["params"]),
                              _leaves(cpu[name]["params"])):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4,
                                   err_msg=f"{name}: {n}")
    assert card[name]["qkv_w_local"] == cpu[name]["qkv_w_local"]
