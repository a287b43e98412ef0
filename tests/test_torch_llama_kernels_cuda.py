"""The Llama slice's CUDA kernels on the card: the RMSNorm forward and dx
backward and the RoPE kernel, each against its plain PyTorch version on the
same inputs; autograd through both; their launch counts; inputs they
refuse; and a tiny fp32 eager Llama on the card against the same model on
the CPU.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest tests/test_torch_llama_kernels_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import device_guard
from paddle_tpu_torch.incubate.nn import functional as TI
from paddle_tpu_torch.kernels import rms_norm as RN
from paddle_tpu_torch.kernels import rope as RP
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.nn import functional_call, functional_train_graph

pytestmark = pytest.mark.cuda

# max-abs err / max-abs ref: fp32 sums in another order; bf16 one rounding
# of the output (an fp32 difference can flip it by one ulp)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1e-30)).item()


def _randn(card, *shape, seed=0, dtype=torch.float32, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale
                            + shift).to(card, dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,H", [(8192, 2048), (37, 2048), (1, 2048),
                                    (13, 100), (37, 4095), (5, 4096),
                                    (7, 6)])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm_kernels_match_plain(card, dtype, rows, H, eps):
    x = _randn(card, rows, H, seed=rows + H, dtype=dtype, scale=3.0,
               shift=1.0)
    w = _randn(card, H, seed=1)
    dy = _randn(card, rows, H, seed=2, dtype=dtype)
    n = (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd_dx.LAUNCHES)
    y, rstd = RN.rms_norm_fwd(x, w, eps)
    dx = RN.rms_norm_bwd_dx(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd_dx.LAUNCHES) == \
        (n[0] + 1, n[1] + 1)
    y_p, rstd_p = RN.rms_norm_fwd_plain(x, w, eps)
    dx_p, _ = RN.rms_norm_bwd_plain(x, w, rstd_p, dy)
    assert y.dtype == dtype and dx.dtype == dtype
    assert rstd.dtype == torch.float32 and rstd.shape == (rows,)
    assert ((rstd - rstd_p).abs() / rstd_p).max().item() <= 1e-5
    assert _rel(y, y_p) <= TOL[dtype]
    assert _rel(dx, dx_p) <= TOL[dtype]


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_rms_norm_autograd_unaligned_rows_and_weight_dtypes(card, wdtype):
    """A row base that is not 16-byte aligned takes the one-element path;
    the autograd Function's dw is the fp32 cross-row sum in the weight's
    dtype; a bf16 weight is cast for the kernel."""
    H = 2048
    big = torch.randn(65 * H + 3, device=card)
    x = big[3:].view(65, H)                         # 12-byte offset
    assert x.data_ptr() % 16
    w = torch.randn(H, device=card).to(wdtype).requires_grad_(True)
    y, rstd = RN.rms_norm_fwd(x, w.detach(), 1e-5)
    y_p, rstd_p = RN.rms_norm_fwd_plain(x, w.detach(), 1e-5)
    assert _rel(y, y_p) <= 1e-5
    xr = x.clone().requires_grad_(True)
    dy = torch.randn(65, H, device=card)
    n = (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd_dx.LAUNCHES)
    gx, gw = torch.autograd.grad(RN.rms_norm(xr, w, 1e-5), (xr, w), dy)
    assert (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd_dx.LAUNCHES) == \
        (n[0] + 1, n[1] + 1)
    dx_p, dw_p = RN.rms_norm_bwd_plain(x, w.detach(), rstd_p, dy)
    assert gw.dtype == wdtype
    assert _rel(gx, dx_p) <= 1e-5
    assert _rel(gw, dw_p) <= (1e-5 if wdtype == torch.float32 else 1e-2)


def test_rms_norm_refuses_bad_inputs(card):
    x = torch.randn(4, 64, device=card)
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        RN.rms_norm_fwd(x.double(), torch.ones(64, device=card), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        RN.rms_norm_fwd(x.t(), torch.ones(4, device=card), 1e-5)
    with pytest.raises(ValueError, match="elements"):
        RN.rms_norm_fwd(x, torch.ones(32, device=card), 1e-5)
    with pytest.raises(ValueError, match="is on"):
        RN.rms_norm_fwd(x, torch.ones(64), 1e-5)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 1024, 16, 128), (8, 1024, 4, 128),
                                   (2, 7, 3, 6), (1, 5, 2, 10),
                                   (2, 33, 2, 64), (1, 9, 3, 24)])
@pytest.mark.parametrize("neg_sin", [False, True])
def test_rope_kernel_matches_plain(card, dtype, shape, neg_sin):
    B, S, H, D = shape
    x = _randn(card, *shape, seed=S + H, dtype=dtype)
    ang = _randn(card, S, D // 2, seed=3, scale=2.0)
    c, s = torch.cos(ang), torch.sin(ang)
    n = RP.rope.LAUNCHES
    y = RP.rope(x, c, s, neg_sin)
    torch.cuda.synchronize()
    assert RP.rope.LAUNCHES == n + 1
    y_p = RP.rope_plain(x, c, s, neg_sin)
    assert y.dtype == dtype and y.shape == x.shape and y.is_contiguous()
    assert _rel(y, y_p) <= TOL[dtype]


def test_rope_strided_views_and_autograd(card):
    """q and k as strided views of a fused projection are read in place;
    the backward is the kernel with -sin; the tables get no gradient."""
    B, S, H, D = 2, 64, 4, 128
    qkv = torch.randn(B, S, H, 3, D, device=card, dtype=torch.bfloat16)
    c, s = TL.rope_tables(TL.LlamaConfig(hidden_size=H * D, num_heads=H),
                          S, card)
    view = qkv[:, :, :, 1]
    assert RP.rope(view, c, s).equal(RP.rope(view.contiguous(), c, s))
    x = torch.randn(B, S, H, D, device=card, requires_grad=True)
    n = RP.rope.LAUNCHES
    y = RP.apply_rope(x, c, s)
    (g,) = torch.autograd.grad(y.sum(), (x,))     # an expanded cotangent
    assert RP.rope.LAUNCHES == n + 2
    ref = RP.rope_plain(torch.ones_like(x), c, s, neg_sin=True)
    assert _rel(g, ref) <= 1e-5


def test_fused_rotary_position_embedding_launches_and_refusals(card):
    q = torch.randn(2, 32, 8, 64, device=card, requires_grad=True)
    k = torch.randn(2, 32, 2, 64, device=card, requires_grad=True)
    n = RP.rope.LAUNCHES
    oq, ok, ov = TI.fused_rotary_position_embedding(q, k)
    assert ov is None and RP.rope.LAUNCHES == n + 2
    (oq.float().square().sum() + ok.float().square().sum()).backward()
    assert RP.rope.LAUNCHES == n + 4
    cpu = TI.fused_rotary_position_embedding(q.detach().cpu(),
                                             k.detach().cpu())
    assert _rel(oq.cpu(), cpu[0]) <= 1e-5 and _rel(ok.cpu(), cpu[1]) <= 1e-5
    with pytest.raises(TypeError, match="bfloat16 or float16"):
        RP.rope(q.detach().double(), torch.ones(32, 32, device=card),
                torch.ones(32, 32, device=card))
    # a D that is not contiguous is taken, as on the CPU: copied, then
    # rotated by the kernel
    xt = q.detach().transpose(2, 3)
    assert xt.stride(-1) != 1
    ang = _randn(card, 32, 4, seed=4)
    c, s = torch.cos(ang), torch.sin(ang)
    n = RP.rope.LAUNCHES
    got = RP.rope(xt, c, s)
    assert RP.rope.LAUNCHES == n + 1
    assert _rel(got, RP.rope_plain(xt, c, s)) <= 1e-5
    assert _rel(got.cpu(), RP.rope_plain(xt.cpu(), c.cpu(), s.cpu())) <= 1e-5


# ---------------------------------------------------------------------------
# a tiny eager Llama, card vs CPU
# ---------------------------------------------------------------------------
def test_tiny_llama_card_matches_cpu(card):
    cfg = TL.LlamaConfig(vocab_size=256, hidden_size=256, num_layers=2,
                         num_heads=2, num_kv_heads=1, intermediate_size=512,
                         dtype=torch.float32)
    with device_guard("cpu"):
        model = TL.Llama(cfg)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 256, (2, 128))
    labels = rng.randint(0, 256, (2, 128))

    def run(dev):
        params = functional_train_graph(model, device=dev)[0]
        for t in params.values():
            t.requires_grad_(True)
        logits, _ = functional_call(model, params, {},
                                    torch.from_numpy(tokens).to(dev))
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 256), torch.from_numpy(labels).to(dev)
            .reshape(-1))
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.item(), dict(zip(params, grads))

    n = RN.rms_norm_fwd.LAUNCHES
    l_card, g_card = run(card)
    assert RN.rms_norm_fwd.LAUNCHES - n == 2 * cfg.num_layers + 1
    l_cpu, g_cpu = run("cpu")
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for name, g in g_cpu.items():
        err = (g_card[name].cpu() - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item(), name
