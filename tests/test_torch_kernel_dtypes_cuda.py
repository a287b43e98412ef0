"""The norm, RoPE, Adam and paged attention kernels at float16 on the card,
each against its plain PyTorch version on the same inputs, and the public
entries that route fp16 tensors to them (``nn.functional.layer_norm``,
``nn.functional.rms_norm``, incubate's ``fused_rotary_position_embedding``,
``AdamW`` over an fp16 leaf): they launch the kernels and raise nothing,
where the JAX package's kernels return a result for each. Adam also takes a
gradient in another float dtype than p, read in its own dtype.

Tolerance: max-abs error over max(max-abs plain, 1), the fp16 tier 1e-2 of
the norm kernels (fp32 arithmetic in both, one rounding to fp16, so an fp32
difference flips at most an ulp), and 1e-5 for the RMSNorm backward's fp32
dw (the same products summed in another order); Adam one ulp of each array's dtype at its
largest value (the plain version follows the kernel operation by
operation), and the fp16 tier for AdamW against its composed CPU update.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_kernel_dtypes_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.nn import functional as TI
from paddle_tpu_torch.kernels import fused_adam as FAD
from paddle_tpu_torch.kernels import layer_norm as LN
from paddle_tpu_torch.kernels import paged_attention as PA
from paddle_tpu_torch.kernels import ragged_paged_attention as RPA
from paddle_tpu_torch.kernels import rms_norm as RN
from paddle_tpu_torch.kernels import rope as RP
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer.optimizer import AdamW

pytestmark = pytest.mark.cuda

TOL = 1e-2
ULP = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}     # Adam: fp32 as test_fused_adam's rtol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1.0)).item()


def _randn(card, *shape, seed=0, dtype=torch.float16, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(card, dtype)


@pytest.mark.parametrize("rows,H", [(8192, 768), (37, 2048), (13, 100)])
def test_norm_kernels_fp16_match_plain(card, rows, H):
    x, dy = _randn(card, rows, H, scale=3.0), _randn(card, rows, H, seed=1)
    w, b = (_randn(card, H, seed=s, dtype=torch.float32) for s in (2, 3))
    y, mean, rstd = LN.layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = LN.layer_norm_bwd(x, w, mean, rstd, dy)
    y_p, mean_p, rstd_p = LN.layer_norm_fwd_plain(x, w, b, 1e-5)
    dx_p = LN.layer_norm_bwd_plain(x, w, mean_p, rstd_p, dy)[0]
    _, dw_p, db_p = LN.layer_norm_bwd_plain(x, w, mean, rstd, dy,
                                            need_dx=False)
    assert y.dtype == dx.dtype == torch.float16
    assert _rel(y, y_p) <= TOL and _rel(dx, dx_p) <= TOL
    assert _rel(dw, dw_p) <= 1e-5 and _rel(db, db_p) <= 1e-5
    y, rs = RN.rms_norm_fwd(x, w, 1e-6)
    dx, dw = RN.rms_norm_bwd(x, w, rs, dy)
    y_p, rs_p = RN.rms_norm_fwd_plain(x, w, 1e-6)
    dx_p, _ = RN.rms_norm_bwd_plain(x, w, rs_p, dy)
    # dw: fp32 sums of the same products (the kernel's rstd on both sides)
    _, dw_p = RN.rms_norm_bwd_plain(x, w, rs, dy, need_dx=False)
    assert y.dtype == dx.dtype == torch.float16
    assert _rel(y, y_p) <= TOL and _rel(dx, dx_p) <= TOL
    assert dw.dtype == torch.float32 and _rel(dw, dw_p) <= 1e-5


def test_public_norm_entries_launch_at_fp16(card):
    x = _randn(card, 4, 64, 256, scale=2.0).requires_grad_()
    w = _randn(card, 256, seed=1, dtype=torch.float32).requires_grad_()
    b = _randn(card, 256, seed=2, dtype=torch.float32).requires_grad_()
    n = (LN.layer_norm_fwd.LAUNCHES, LN.layer_norm_bwd.LAUNCHES)
    y = TF.layer_norm(x, 256, w, b, 1e-5)
    y.float().square().sum().backward()
    assert (LN.layer_norm_fwd.LAUNCHES, LN.layer_norm_bwd.LAUNCHES) == \
        (n[0] + 1, n[1] + 1)
    ref = TF.layer_norm(x.detach().cpu(), 256, w.detach().cpu(),
                        b.detach().cpu(), 1e-5)
    assert y.dtype == torch.float16 and _rel(y.cpu(), ref) <= TOL
    n = (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd.LAUNCHES)
    y = TF.rms_norm(x, w, epsilon=1e-6)
    y.float().square().sum().backward()
    assert (RN.rms_norm_fwd.LAUNCHES, RN.rms_norm_bwd.LAUNCHES) == \
        (n[0] + 1, n[1] + 1)
    ref = TF.rms_norm(x.detach().cpu(), w.detach().cpu(), epsilon=1e-6)
    assert y.dtype == torch.float16 and _rel(y.cpu(), ref) <= TOL


def test_rope_fp16_kernel_and_fused_op(card):
    q = _randn(card, 2, 64, 8, 128).requires_grad_()
    k = _randn(card, 2, 64, 2, 128, seed=1).requires_grad_()
    ang = torch.from_numpy(np.random.RandomState(2).uniform(
        -3, 3, (64, 64)).astype(np.float32)).to(card)
    y = RP.rope(q.detach(), ang.cos(), ang.sin())
    assert y.dtype == torch.float16
    assert _rel(y, RP.rope_plain(q.detach(), ang.cos(), ang.sin())) <= TOL
    n = RP.rope.LAUNCHES
    oq, ok, _ = TI.fused_rotary_position_embedding(q, k)
    (oq.float().square().sum() + ok.float().square().sum()).backward()
    assert RP.rope.LAUNCHES == n + 4 and oq.dtype == torch.float16
    cpu = TI.fused_rotary_position_embedding(q.detach().cpu(),
                                             k.detach().cpu())
    assert _rel(oq.cpu(), cpu[0]) <= TOL and _rel(ok.cpu(), cpu[1]) <= TOL


@pytest.mark.parametrize("pdt,gdt,mdt", [
    (torch.float16, torch.float16, torch.float16),
    (torch.float16, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float32, torch.float16, torch.bfloat16)])
def test_adam_fp16_and_mixed_gradient_match_plain(card, pdt, gdt, mdt):
    shape = (512, 384)
    p = _randn(card, *shape, dtype=pdt)
    g = _randn(card, *shape, seed=1, dtype=gdt, scale=0.01)
    slot = {"moment1": _randn(card, *shape, seed=2, dtype=mdt, scale=0.01),
            "moment2": _randn(card, *shape, seed=3, dtype=mdt,
                              scale=1e-4).abs()}
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=0.01)
    pp, sp = p.clone(), {k: v.clone() for k, v in slot.items()}
    n = FAD.adam_update.LAUNCHES
    FAD.adam_update(p, g, slot, 1e-3, 3, None, **kw)
    assert FAD.adam_update.LAUNCHES == n + 1
    FAD.adam_update_plain(pp, g, sp, 1e-3, 3, None, **kw)
    assert p.dtype == pdt and slot["moment1"].dtype == mdt
    for got, ref in ((p, pp), (slot["moment1"], sp["moment1"]),
                     (slot["moment2"], sp["moment2"])):
        ulp = ULP[got.dtype] * ref.float().abs()
        assert ((got.float() - ref.float()).abs() <= ulp + 1e-30).all()


def test_adamw_steps_an_fp16_leaf_through_the_kernel(card):
    params = {"w": _randn(card, 512, 256).requires_grad_(False)}
    grads = {"w": _randn(card, 512, 256, seed=1, scale=0.01)}
    opt = AdamW(1e-3, weight_decay=0.01)
    state = opt.init_state(params)
    ref = {"w": params["w"].cpu().clone()}
    ref_state = opt.init_state(ref)
    n = FAD.adam_update.LAUNCHES
    opt.apply(params, grads, state)
    assert FAD.adam_update.LAUNCHES == n + 1
    opt.apply(ref, {"w": grads["w"].cpu()}, ref_state)
    assert params["w"].dtype == torch.float16
    assert _rel(params["w"].cpu(), ref["w"]) <= TOL


def test_paged_kernels_fp16_match_plain(card):
    rng = np.random.RandomState(0)
    hq, hkv, D, bs, nb, NB = 8, 2, 128, 16, 6, 40
    t = lambda a, dt=torch.float16: torch.from_numpy(a).to(card, dt)
    k_pool = t(rng.randn(hkv, NB, bs, D).astype(np.float32))
    v_pool = t(rng.randn(hkv, NB, bs, D).astype(np.float32))
    tables = t(rng.permutation(np.arange(1, NB))[:4 * nb].reshape(4, nb)
               .astype(np.int32), torch.int32)
    lens = t(np.array([5 * bs + 3, bs + 1, 0, 2 * bs], np.int32),
             torch.int32)
    q = t(rng.randn(4, hq, D).astype(np.float32))
    scale = 1.0 / np.sqrt(D)
    assert PA.kernel_plan(q, k_pool, tables)["design"] == "bulk-ring"
    ref = PA.paged_decode_attention_plain(q, k_pool, v_pool, tables, lens,
                                          scale)
    for splits in (None, 1, 3):     # the plan's, one, and a merge of three
        n = PA.paged_decode_attention.LAUNCHES
        out = PA.paged_decode_attention(q, k_pool, v_pool, tables, lens,
                                        scale, splits=splits)
        assert PA.paged_decode_attention.LAUNCHES == n + 1
        assert out.dtype == torch.float16 and _rel(out, ref) <= TOL
    q_lens = t(np.array([1, 7, 0, 3], np.int32), torch.int32)
    qr = t(rng.randn(4, 7, hq, D).astype(np.float32))
    n = RPA.ragged_paged_attention.LAUNCHES
    out = RPA.ragged_paged_attention(qr, k_pool, v_pool, tables, q_lens,
                                     lens, scale)
    assert RPA.ragged_paged_attention.LAUNCHES == n + 1
    ref = RPA.ragged_paged_attention_plain(qr, k_pool, v_pool, tables,
                                           q_lens, lens, scale)
    assert out.dtype == torch.float16 and _rel(out, ref) <= TOL
