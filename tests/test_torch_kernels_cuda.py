"""The port's CUDA kernels on the card: each against its plain PyTorch
version on the same inputs, the wrapper's refusals, and the serving engine
on the card against the same engine on the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.models import gpt as G

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, dtype, hq, hkv, D, bs, seed=0):
    """Row 0 decodes, row 1 prefills a chunk mid-sequence (its kv_len not a
    multiple of bs), row 2 is empty, row 3 is a fresh prefill, row 4 sees no
    key (kv_len < q_len)."""
    rng = np.random.RandomState(seed)
    C, NB = 24, 64
    q_lens = np.array([1, 24, 0, 7, 5], np.int32)
    kv_lens = np.array([5 * bs + 3, 3 * bs + 1, 0, 7, 2], np.int32)
    nb = -(-int(kv_lens.max()) // bs) + 1
    tables = np.zeros((5, nb), np.int32)
    free = list(rng.permutation(np.arange(1, NB)))
    for r in range(5):
        for j in range(-(-int(kv_lens[r]) // bs)):
            tables[r, j] = free.pop()

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    return [t(rng.randn(5, C, hq, D).astype(np.float32)),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(rng.randn(hkv, NB, bs, D).astype(np.float32)),
            t(tables, torch.int32), t(q_lens, torch.int32),
            t(kv_lens, torch.int32)], 1.0 / np.sqrt(D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,D,bs", [(4, 4, 16, 8), (8, 2, 16, 8),
                                         (16, 16, 128, 32), (16, 4, 128, 32),
                                         (4, 4, 64, 16)])
def test_kernel_matches_plain(card, dtype, hq, hkv, D, bs):
    args, scale = _case(card, dtype, hq, hkv, D, bs)
    before = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(*args, scale)
    torch.cuda.synchronize()
    assert RPA.ragged_paged_attention.LAUNCHES == before + 1
    ref = RPA.ragged_paged_attention_plain(*args, scale)
    assert RPA.ragged_paged_attention.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == args[0].shape
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    # fp32: summation order only; bf16: the output's rounding (the rel
    # bound of test_ragged_serving)
    tol = 1e-5 * max(top, 1.0) if dtype == torch.float32 else 1e-2 * top
    assert err <= tol, (err, tol)
    for r, ql in enumerate(args[4].tolist()):
        assert (out[r, ql:] == 0).all()      # masked columns, empty row
    assert (out[4, :2] == 0).all()           # no visible key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_stops_at_the_table_width(card, dtype):
    """A row whose kv_len runs past nb * bs sees only its table's nb pages,
    as the TPU grid (R, H_kv, nb) and the plain version do; the row after it
    holds other pages, which a read past the row's table would pick up."""
    args, scale = _case(card, dtype, 4, 4, 16, 8)
    tables, kv_lens = args[3].cpu(), args[5].cpu()
    nb = tables.shape[1]
    kv_lens[0] = nb * 8 + 13                  # 2 pages past the table
    tables[0, 6:] = torch.tensor([60, 61, 62, 63][:nb - 6], dtype=torch.int32)
    args[3], args[5] = tables.to(card), kv_lens.to(card)
    out = RPA.ragged_paged_attention(*args, scale)
    ref = RPA.ragged_paged_attention_plain(*args, scale)
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    tol = 1e-5 * max(top, 1.0) if dtype == torch.float32 else 1e-2 * top
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("bad", ["split_on_cuda_core_route",
                                 "page_above_shared_memory",
                                 "splits_above_16"])
def test_kernel_c_entry_refuses_shapes_it_does_not_take(card, bad):
    """Calls the kernel's C entry refuses before launching: the wrapper
    raises and counts no launch. (Every head dim up to 256, odd D and
    misaligned pools have a route: test_torch_ragged_hopper_cuda.py.) The
    CUDA-core route (here D 12, not whole 16-byte words) takes no split;
    its fp32 page of 128 keys at D 250 (not whole 16-byte words either;
    fp32 at D 256 has the TF32 route, which takes every page size) does not
    fit a block's shared memory; no route takes more than 16 splits."""
    dtype, D, bs, splits = {
        "split_on_cuda_core_route": (torch.bfloat16, 12, 8, 2),
        "page_above_shared_memory": (torch.float32, 250, 128, None),
        "splits_above_16": (torch.bfloat16, 16, 8, 17)}[bad]
    args, scale = _case(card, dtype, 4, 4, D, bs)
    before = RPA.ragged_paged_attention.LAUNCHES
    with pytest.raises(RuntimeError, match="invalid argument"):
        RPA.ragged_paged_attention(*args, scale, splits=splits)
    assert RPA.ragged_paged_attention.LAUNCHES == before


@pytest.mark.parametrize("bad", ["fp64", "int8_pool", "noncontig_q",
                                 "pool_on_cpu"])
def test_kernel_refuses_what_it_does_not_take(card, bad):
    args, scale = _case(card, torch.bfloat16, 4, 4, 16, 8)
    if bad == "fp64":
        args[:3] = [a.double() for a in args[:3]]
    elif bad == "int8_pool":
        args[1], args[2] = args[1].to(torch.int8), args[2].to(torch.int8)
    elif bad == "noncontig_q":
        args[0] = args[0].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "pool_on_cpu":
        args[1] = args[1].cpu()
    before = RPA.ragged_paged_attention.LAUNCHES
    with pytest.raises((TypeError, ValueError)):
        RPA.ragged_paged_attention(*args, scale)
    assert RPA.ragged_paged_attention.LAUNCHES == before


def test_engine_on_card_matches_cpu(card):
    cfg = G.GPTConfig(vocab_size=97, hidden_size=32, num_layers=2,
                      num_heads=4, max_seq_len=128, dtype=torch.float32)
    kw = dict(max_batch=2, block_size=8, num_blocks=24, max_blocks_per_seq=8,
              chunk=8, decode_burst=4, adaptive_mix=False, ragged=True)
    params = G.init_hybrid_params(cfg, 0, "cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 97, (n,)) for n in (5, 13, 9, 16)]

    def run(device):
        eng = ServingEngine(params, cfg, device=device, **kw)
        rids = [eng.add_request(p, 6) for p in prompts]
        res = eng.run()
        return [res[r] for r in rids], eng

    before = RPA.ragged_paged_attention.LAUNCHES
    out_card, eng = run(card)
    launches = RPA.ragged_paged_attention.LAUNCHES - before
    assert launches == cfg.num_layers * eng.decode_microsteps > 0
    assert out_card == run("cpu")[0]
