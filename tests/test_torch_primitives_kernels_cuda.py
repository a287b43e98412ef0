"""The tile primitives' CUDA kernels on the card (``paddle_tpu_torch.kernels
.primitives``): ``elementwise`` and ``row_reduce`` compiled from the caller's
``fn`` by ``kernels/_codegen.py``, and the LayerNorm forward and backward
with dg / db summed inside the kernel, each against its plain PyTorch
version on the same inputs (the LayerNorm backward also at 28680
columns); their launch counts; what they refuse.

Tolerances, max-abs error over max-abs plain: fp32 1e-5 (the same fp32 ops,
transcendental functions from the same CUDA math library, sums in another
order); bf16 / fp16 1e-2 (one rounding of each output, so an fp32
difference flips at most an ulp). dg / db are also held bit for bit across
two calls (the backward folds its partial sums in a fixed order).

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_primitives_kernels_cuda.py --noconftest -q

The generated kernels of the op table are built at once, in parallel, by
the module's first test (about a minute cold).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu_torch.enforce import InvalidArgumentError
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import _codegen as CG
from paddle_tpu_torch.kernels import primitives as P

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]

# one fn for each op of the generator's set; inputs are N(0, 1), so a
# domain-limited op takes abs() + something first
OPS = {
    "add": (lambda a, b: a + b, 2), "sub": (lambda a, b: b - a, 2),
    "mul": (lambda a, b: a * b, 2), "div": (lambda a, b: b / (a.abs() + 1),
                                            2),
    "scalar_forms": (lambda a: 2.5 - a * 3 + a / 4 + 1 / (a.abs() + 1), 1),
    "neg": (lambda a: -a, 1), "abs": (torch.abs, 1),
    "reciprocal": (lambda a: torch.reciprocal(a.abs() + 0.5), 1),
    "exp": (torch.exp, 1), "log": (lambda a: torch.log(a.abs() + 0.1), 1),
    "log1p": (lambda a: torch.log1p(a.abs()), 1), "expm1": (torch.expm1, 1),
    "sqrt": (lambda a: torch.sqrt(a.abs()), 1),
    "rsqrt": (lambda a: torch.rsqrt(a.abs() + 0.1), 1),
    "tanh": (torch.tanh, 1), "sigmoid": (torch.sigmoid, 1),
    "erf": (torch.erf, 1), "sin": (torch.sin, 1), "cos": (torch.cos, 1),
    "pow": (lambda a: a ** 3 - a ** 2 + a.abs() ** 0.75, 1),
    "pow_swapped": (lambda a: 2.0 ** a, 1),
    "gelu": (F.gelu, 1),
    "gelu_tanh": (lambda a: F.gelu(a, approximate="tanh"), 1),
    "relu": (F.relu, 1), "silu": (F.silu, 1),
    "clamp": (lambda a: torch.clamp(a, -0.5, 0.75), 1),
    "maximum": (torch.maximum, 2), "minimum": (torch.minimum, 2),
    "compare": (lambda a, b: (a > b).float() + 2 * (a < 0.5).float()
                + 4 * (a >= b).float() + 8 * (a <= 0).float()
                + 16 * (a == b).float() + 32 * (a != b).float(), 2),
    "where": (lambda a, b: torch.where(a > b, a - b, b * 2), 2),
    "cast": (lambda a: a.to(torch.bfloat16).float() + a.half().float(), 1),
    "three": (lambda a, b, c: a * b - c, 3),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    # every generated kernel of this file at once: nvcc in parallel
    srcs = [CG.elementwise_source(CG.trace(fn, n), [dt] * n, dt)
            for fn, n in OPS.values() for dt in DTYPES]
    srcs += [CG.row_reduce_source(CG.trace(fn, 2), ident, dt)
             for fn, ident in ((torch.add, 0.0), (torch.maximum, -np.inf),
                               (torch.minimum, np.inf))
             for dt in DTYPES]
    _build.build_generated_many(srcs)
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / max(b.float().abs().max().item(), 1e-30)).item()


def _randn(card, *shape, seed=0, dtype=torch.float32, scale=1.0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(*shape) * scale).astype(
        np.float32)).to(card, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("op", list(OPS))
def test_elementwise_op_matches_plain(card, op, dtype):
    fn, n = OPS[op]
    xs = [_randn(card, 67, 129, seed=s, dtype=dtype) for s in range(n)]
    if op == "compare":
        xs[1][:3] = xs[0][:3]                      # equal pairs
    before = P.elementwise.LAUNCHES
    got = P.elementwise(fn, *xs)
    torch.cuda.synchronize()
    assert P.elementwise.LAUNCHES == before + 1
    ref = P.elementwise_plain(fn, xs, dtype)
    assert got.dtype == dtype and got.shape == xs[0].shape
    assert torch.isfinite(got.float()).all()
    assert _rel(got, ref) <= TOL[dtype], _rel(got, ref)


@pytest.mark.parametrize("shape", [(8192, 1024), (3, 5, 7), (1000003,)])
def test_elementwise_vector_tail_unaligned_and_mixed(card, shape):
    """Whole 16-byte groups, the tail past them, an unaligned view (one
    element a thread), mixed operand dtypes into an fp32 output."""
    fn = lambda a, b: a * b + 1.0
    a = _randn(card, *shape, dtype=torch.bfloat16)
    b = _randn(card, *shape, seed=1)
    got = P.elementwise(fn, a, b, out_dtype=torch.float32)
    ref = P.elementwise_plain(fn, [a, b], torch.float32)
    assert got.dtype == torch.float32 and _rel(got, ref) <= 1e-5
    flat = _randn(card, a.numel() + 1, dtype=torch.bfloat16)
    view = flat[1:].view(shape)                    # 2-byte offset
    assert view.data_ptr() % 16
    got = P.elementwise(fn, view, view)
    assert _rel(got, P.elementwise_plain(fn, [view, view], view.dtype)) \
        <= 1e-2


def test_elementwise_refuses_without_launching(card):
    x = _randn(card, 4, 8)
    before = P.elementwise.LAUNCHES
    with pytest.raises(NotImplementedError, match="aten.sum"):
        P.elementwise(lambda a: a - a.sum(), x)
    two = torch.tensor(2.0)
    with pytest.raises(NotImplementedError, match="tensor constant"):
        P.elementwise(lambda a: a * two, x)
    with pytest.raises(NotImplementedError, match="float64"):
        P.elementwise(torch.tanh, x.double())
    with pytest.raises(InvalidArgumentError, match="equal shapes"):
        P.elementwise(torch.add, x, x[:, :4])
    with pytest.raises(ValueError, match="is on"):
        P.elementwise(torch.add, x, x.cpu())
    assert P.elementwise.LAUNCHES == before


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("fn,ident", [(torch.add, 0.0),
                                      (torch.maximum, -np.inf),
                                      (torch.minimum, np.inf)],
                         ids=["add", "max", "min"])
@pytest.mark.parametrize("rows,C", [(4096, 100), (64, 1024), (37, 4099),
                                    (512, 32000), (5, 0)])
def test_row_reduce_matches_plain(card, fn, ident, dtype, rows, C):
    x = _randn(card, rows, C, seed=C, dtype=dtype)
    before = P.row_reduce.LAUNCHES
    got = P.row_reduce(fn, ident, x)
    torch.cuda.synchronize()
    assert P.row_reduce.LAUNCHES == before + 1
    ref = P.row_reduce_plain(fn, ident, x)
    assert got.dtype == torch.float32 and got.shape == (rows,)
    if C == 0:
        assert (got == ident).all()
    elif fn is torch.add:
        assert _rel(got, ref) <= 1e-5, _rel(got, ref)
    else:                                  # max / min: exact in any order
        assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("rows,H", [(8192, 768), (8192, 2048), (37, 100),
                                    (3, 16384), (1, 64)])
def test_layer_norm_kernels_match_plain(card, dtype, rows, H):
    x = _randn(card, rows, H, dtype=dtype, scale=3.0) + 1
    g = _randn(card, H, seed=1) * 0.5 + 1
    b = _randn(card, H, seed=2) * 0.1
    dy = _randn(card, rows, H, seed=3, dtype=dtype)
    n = (P.ln_fwd.LAUNCHES, P.ln_bwd.LAUNCHES)
    y, mu, rstd = P.ln_fwd(x, g, b, 1e-5)
    dx, dg, db = P.ln_bwd(x, g, mu, rstd, dy)
    torch.cuda.synchronize()
    assert (P.ln_fwd.LAUNCHES, P.ln_bwd.LAUNCHES) == (n[0] + 1, n[1] + 1)
    y_p, mu_p, rstd_p = P.ln_fwd_plain(x, g, b, 1e-5)
    dx_p, dg_p, db_p = P.ln_bwd_plain(x, g, mu_p, rstd_p, dy)
    assert y.dtype == dx.dtype == dtype
    assert dg.dtype == db.dtype == torch.float32
    assert _rel(y, y_p) <= TOL[dtype] and _rel(dx, dx_p) <= TOL[dtype]
    assert _rel(mu, mu_p) <= 1e-5 and _rel(rstd, rstd_p) <= 1e-5
    assert _rel(dg, dg_p) <= 1e-5 and _rel(db, db_p) <= 1e-5
    # two calls: dg and db bit for bit (the ticket went back to 0)
    _, dg2, db2 = P.ln_bwd(x, g, mu, rstd, dy)
    assert torch.equal(dg, dg2) and torch.equal(db, db2)


def test_layer_norm_autograd_and_refusals(card):
    x = _randn(card, 4, 64, 768, dtype=torch.bfloat16).requires_grad_()
    g = (_randn(card, 768, seed=1) + 1).to(torch.bfloat16).requires_grad_()
    b = _randn(card, 768, seed=2).to(torch.bfloat16).requires_grad_()
    dy = _randn(card, 4, 64, 768, seed=3, dtype=torch.bfloat16)
    y = P.layer_norm(x, g, b)
    gx, gg, gb = torch.autograd.grad(y, (x, g, b), dy)
    assert y.dtype == gx.dtype == torch.bfloat16
    assert gg.dtype == gb.dtype == torch.bfloat16      # the weight's dtype
    cpu = [t.detach().cpu().requires_grad_() for t in (x, g, b)]
    rc = torch.autograd.grad(P.layer_norm(*cpu), cpu, dy.cpu())
    for got, ref in zip((gx, gg, gb), rc):
        assert _rel(got.cpu(), ref) <= 1e-2
    # a row of 28672 + 8 columns (wider than the shared-memory partial of
    # the primitives' first backward took): the LayerNorm kernel's
    # column-tiled partial, held to the plain version
    H = 28672 + 8
    wide = _randn(card, 2, H, seed=4, scale=3.0) + 1
    gw, bw = _randn(card, H, seed=5) * 0.5 + 1, _randn(card, H, seed=6) * 0.1
    dyw = _randn(card, 2, H, seed=7)
    _, mu, rstd = P.ln_fwd(wide, gw, bw, 1e-5)
    before = P.ln_bwd.LAUNCHES
    dx, dg, db = P.ln_bwd(wide, gw, mu, rstd, dyw)
    torch.cuda.synchronize()
    assert P.ln_bwd.LAUNCHES == before + 1
    dx_p, dg_p, db_p = P.ln_bwd_plain(wide, gw, mu, rstd, dyw)
    assert _rel(dx, dx_p) <= TOL[torch.float32]
    assert _rel(dg, dg_p) <= 1e-5 and _rel(db, db_p) <= 1e-5
