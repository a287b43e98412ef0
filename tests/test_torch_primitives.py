"""The port's tile primitives (``paddle_tpu_torch.kernels.primitives``)
against the JAX package's ``paddle_tpu.kernels.pallas.primitives``, run in
interpret mode on the CPU, and the code generator that compiles a caller's
``fn`` for the card (``paddle_tpu_torch.kernels._codegen``).

On the CPU every primitive takes its plain PyTorch version, the one
``chip_smoke.py`` phase 31 holds the CUDA kernels to on the card. Inputs are
made with numpy from a seed and handed to both packages. Tolerances are the
JAX tests' (``test_pallas_kernels.py::test_kps_*``): elementwise 1e-5 (a * b
+ 1) and 1e-6 (tanh); row_reduce 1e-5 (sum) and 1e-6 (max, min), 1e-4 over
4096 columns; online softmax 1e-5; LayerNorm forward 1e-5 and gradients
2e-4 at fp32. At bf16 / fp16 the JAX kernels compute fn in the input dtype
and the port in fp32 with one rounding, so they agree within one ulp of the
narrow dtype; the LayerNorm at bf16 / fp16 is held to the fp16 tier of the
flash tests (max-abs error over max(max-abs reference, 1) within 2e-2).
The CUDA kernels themselves are tested on the card by
``test_torch_primitives_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.enforce import InvalidArgumentError as JInvalidArgument
from paddle_tpu.kernels.pallas import primitives as JP
from paddle_tpu_torch.enforce import InvalidArgumentError
from paddle_tpu_torch.kernels import _codegen as CG
from paddle_tpu_torch.kernels import primitives as P

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
MANTISSA = {torch.bfloat16: 7, torch.float16: 10, torch.float32: 23}


def _rand(*shape, seed=0, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _both(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype), jnp.asarray(a).astype(JDT[dtype])


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


def _within_ulps(got, ref, dtype, ulps=1.0):
    """|got - ref| within ``ulps`` units in the last place of ``dtype`` at
    |ref| (a floor of one ulp at 1 for values near zero)."""
    mag = np.maximum(np.abs(ref), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - MANTISSA[dtype])
    err = np.abs(got - ref)
    assert (err <= ulps * ulp + 2.0 ** -MANTISSA[dtype] * 1e-3).all(), \
        float((err / ulp).max())


def _tier(got, ref, tol=2e-2, what=""):
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1.0)
    assert err <= tol, (what, err, tol)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------
def test_elementwise_matches_jax_kernel_fp32():
    x, jx = _both(_rand(64, 256))
    y, jy = _both(_rand(64, 256, seed=1))
    n = P.elementwise.LAUNCHES
    out = P.elementwise(lambda a, b: a * b + 1.0, x, y)
    ref = JP.elementwise(lambda a, b: a * b + 1.0, jx, jy)
    assert P.elementwise.LAUNCHES == n        # the CPU path launches none
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    x3, jx3 = _both(_rand(4, 16, 128, seed=2))
    out3 = P.elementwise(torch.tanh, x3)
    ref3 = JP.elementwise(jnp.tanh, jx3)
    assert out3.shape == (4, 16, 128)
    np.testing.assert_allclose(out3.numpy(), np.asarray(ref3), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("out", ["same", "float32"])
def test_elementwise_narrow_inputs_within_one_ulp_of_jax(dtype, out):
    a, ja = _both(_rand(32, 256, lo=0.5, hi=2.0), dtype)
    b, jb = _both(_rand(32, 256, seed=1, lo=0.5, hi=2.0), dtype)
    tout = dtype if out == "same" else torch.float32
    got = P.elementwise(lambda u, v: u * v + 1.0, a, b, out_dtype=tout)
    ref = JP.elementwise(lambda u, v: u * v + 1.0, ja, jb,
                         out_dtype=JDT[tout])
    assert got.dtype == tout and ref.dtype == JDT[tout]
    _within_ulps(_f32(got), _f32(ref), dtype)
    got_t = P.elementwise(torch.tanh, a, out_dtype=tout)
    ref_t = JP.elementwise(jnp.tanh, ja, out_dtype=JDT[tout])
    _within_ulps(_f32(got_t), _f32(ref_t), dtype)


def test_elementwise_three_inputs_and_0d():
    arrs = [_both(_rand(8, 3, 48, seed=s)) for s in range(3)]
    got = P.elementwise(lambda a, b, c: a * b - c, *(t for t, _ in arrs))
    ref = JP.elementwise(lambda a, b, c: a * b - c, *(j for _, j in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    s, js = torch.tensor(0.3), jnp.asarray(0.3, jnp.float32)
    got0 = P.elementwise(torch.tanh, s)
    ref0 = JP.elementwise(jnp.tanh, js)
    assert got0.shape == () and ref0.shape == ()
    np.testing.assert_allclose(float(got0), float(ref0), rtol=1e-6)


def test_elementwise_unequal_shapes_raise_in_both():
    with pytest.raises(InvalidArgumentError, match="equal shapes"):
        P.elementwise(torch.add, torch.zeros(4, 8), torch.zeros(4, 16))
    with pytest.raises(JInvalidArgument, match="equal shapes"):
        JP.elementwise(jnp.add, jnp.zeros((4, 8)), jnp.zeros((4, 16)))


# ---------------------------------------------------------------------------
# row_reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tfn,jfn,ident,tol", [
    (torch.add, jnp.add, 0.0, 1e-5),
    (torch.maximum, jnp.maximum, -np.inf, 1e-6),
    (torch.minimum, jnp.minimum, np.inf, 1e-6)], ids=["add", "max", "min"])
def test_row_reduce_matches_jax_kernel(tfn, jfn, ident, tol):
    x, jx = _both(_rand(32, 512, seed=1))
    n = P.row_reduce.LAUNCHES
    got = P.row_reduce(tfn, ident, x)
    ref = JP.row_reduce(jfn, ident, jx)
    assert P.row_reduce.LAUNCHES == n
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_row_reduce_streams_wide_rows_and_3d():
    x, jx = _both(_rand(2, 8, 4096, seed=2))
    got = P.row_reduce(torch.add, 0.0, x, block_cols=1024)
    ref = JP.row_reduce(jnp.add, 0.0, jx, block_cols=1024)
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_row_reduce_bf16_rows_in_fp32():
    x, jx = _both(_rand(16, 384, seed=3), torch.bfloat16)
    got = P.row_reduce(torch.add, 0.0, x)
    ref = JP.row_reduce(jnp.add, 0.0, jx)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    mx = P.row_reduce(torch.maximum, -np.inf, x)
    np.testing.assert_array_equal(mx.numpy(), x.float().amax(-1).numpy())


def test_row_reduce_any_width_where_jax_needs_lanes():
    """C % 128 is the TPU's lane tiling (ROADMAP parity rule 4): the JAX
    kernel refuses C = 100, the port reduces it."""
    a = _rand(4, 100, seed=4)
    with pytest.raises(JInvalidArgument, match="lane"):
        JP.row_reduce(jnp.add, 0.0, jnp.asarray(a))
    got = P.row_reduce(torch.add, 0.0, torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), a.sum(-1), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# online_softmax_update
# ---------------------------------------------------------------------------
def test_online_softmax_update_two_tiles_match_jax():
    s1, s2 = _rand(8, 64, seed=2), _rand(8, 64, seed=3)
    v1, v2 = _rand(64, 16, seed=4), _rand(64, 16, seed=5)

    def run(mod, t, m, l, acc):
        m, l, acc, _ = mod.online_softmax_update(t(s1), m, l, acc, t(v1))
        m, l, acc, _ = mod.online_softmax_update(t(s2), m, l, acc, t(v2))
        return acc / l[:, None]

    got = run(P, torch.from_numpy, torch.full((8,), -1e30), torch.zeros(8),
              torch.zeros(8, 16))
    ref = run(JP, jnp.asarray, jnp.full((8,), -1e30), jnp.zeros((8,)),
              jnp.zeros((8, 16)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    s, v = np.concatenate([s1, s2], 1), np.concatenate([v1, v2], 0)
    dense = torch.softmax(torch.from_numpy(s), -1) @ torch.from_numpy(v)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# layer_norm
# ---------------------------------------------------------------------------
def _ln_inputs(seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(6, 32, 256).astype(np.float32),
            (rng.rand(256) + 0.5).astype(np.float32),
            (rng.randn(256) * 0.1).astype(np.float32),
            rng.randn(6, 32, 256).astype(np.float32))


def _ln_both(xdt, wdt):
    x, g, b, dy = _ln_inputs()
    xt = torch.from_numpy(x).to(xdt).requires_grad_()
    gt = torch.from_numpy(g).to(wdt).requires_grad_()
    bt = torch.from_numpy(b).to(wdt).requires_grad_()
    y = P.layer_norm(xt, gt, bt)
    grads = torch.autograd.grad(y, (xt, gt, bt), torch.from_numpy(dy)
                                .to(xdt))
    jargs = (jnp.asarray(x).astype(JDT[xdt]), jnp.asarray(g).astype(
        JDT[wdt]), jnp.asarray(b).astype(JDT[wdt]))
    jy = JP.layer_norm(*jargs)
    jdy = jnp.asarray(dy).astype(JDT[xdt])
    jgrads = jax.grad(lambda *a: jnp.sum(
        JP.layer_norm(*a).astype(jnp.float32) * jdy.astype(jnp.float32)),
        argnums=(0, 1, 2))(*jargs)
    return y, grads, jy, jgrads


def test_layer_norm_forward_and_grads_match_jax_fp32():
    y, grads, jy, jgrads = _ln_both(torch.float32, torch.float32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    for got, ref, name in zip(grads, jgrads, ("dx", "dg", "db")):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    # and the composed fp32 LayerNorm
    x, g, b, _ = _ln_inputs()
    ref = F.layer_norm(torch.from_numpy(x), (256,), torch.from_numpy(g),
                       torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
def test_layer_norm_narrow_dtypes_match_jax(xdt, wdt):
    y, grads, jy, jgrads = _ln_both(xdt, wdt)
    assert y.dtype == xdt and jy.dtype == JDT[xdt]
    _within_ulps(_f32(y.detach()), _f32(jy), xdt)
    for got, ref, want, name in zip(grads, jgrads, (xdt, wdt, wdt),
                                    ("dx", "dg", "db")):
        assert got.dtype == want and ref.dtype == JDT[want], name
        _tier(_f32(got), _f32(ref), what=name)


def test_layer_norm_plain_parts():
    """The wrappers' plain versions: the statistics in fp32 [rows], dg / db
    in fp32 before the autograd cast."""
    x, g, b, dy = _ln_inputs()
    x2 = torch.from_numpy(x).reshape(-1, 256).to(torch.bfloat16)
    y, mu, rstd = P.ln_fwd(x2, torch.from_numpy(g), torch.from_numpy(b),
                           1e-5)
    assert (y.dtype, mu.dtype, rstd.dtype) == (torch.bfloat16,) + \
        (torch.float32,) * 2 and mu.shape == (192,)
    dx, dg, db = P.ln_bwd(x2, torch.from_numpy(g), mu, rstd,
                          torch.from_numpy(dy).reshape(-1, 256).bfloat16())
    assert dx.dtype == torch.bfloat16 and dg.dtype == db.dtype == \
        torch.float32
    np.testing.assert_allclose(db.numpy(), dy.reshape(-1, 256).astype(
        np.float32).sum(0), rtol=2e-2, atol=2e-1)
    with pytest.raises(InvalidArgumentError, match="weight and a bias"):
        P.layer_norm(x2, torch.from_numpy(g), None)


# ---------------------------------------------------------------------------
# the code generator
# ---------------------------------------------------------------------------
def _ir_eval(graph, xs):
    """The IR evaluated op by op with torch (fp32): what the emitted CUDA
    function computes, one op per statement."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32)

    def cmp(op):
        return lambda a, b: op(a, b).float()

    ops = {
        "add": torch.add, "sub": torch.sub, "mul": torch.mul,
        "div": torch.div, "pow": torch.pow, "maximum": torch.maximum,
        "minimum": torch.minimum, "gt": cmp(torch.gt), "lt": cmp(torch.lt),
        "ge": cmp(torch.ge), "le": cmp(torch.le), "eq": cmp(torch.eq),
        "ne": cmp(torch.ne), "where": lambda k, a, b: torch.where(
            k != 0, a, b), "neg": torch.neg, "abs": torch.abs,
        "reciprocal": torch.reciprocal, "exp": torch.exp, "log": torch.log,
        "log1p": torch.log1p, "expm1": torch.expm1, "sqrt": torch.sqrt,
        "rsqrt": torch.rsqrt, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
        "erf": torch.erf, "sin": torch.sin, "cos": torch.cos,
        "relu": torch.relu, "silu": F.silu, "const": lambda v: v}
    env = {f"x{i}": x for i, x in enumerate(xs)}
    for n in graph.nodes:
        args = [env[a] if isinstance(a, str) else c(a) for a in n.args]
        if n.op == "gelu":
            env[n.name] = F.gelu(args[0], approximate=n.attr)
        elif n.op == "round":
            dt = {"bfloat16": torch.bfloat16, "float16": torch.float16}
            env[n.name] = args[0].to(dt[n.attr]).float()
        else:
            env[n.name] = ops[n.op](*args)
    return env[graph.out].expand(xs[0].shape)


FNS = {
    "mul_add": (lambda a, b: a * b + 1.0, 2),
    "sub_swapped": (lambda a, b: b - a, 2),
    "rsub": (lambda a: 2.5 - a, 1),
    "add_sub_alpha": (lambda a, b: torch.sub(a, b, alpha=2)
                      + torch.add(b, a, alpha=0.5), 2),
    "div_swapped": (lambda a, b: b / (a.abs() + 1), 2),
    "rdiv": (lambda a: 3.0 / (a * a + 1), 1),
    "neg_abs_recip": (lambda a: torch.reciprocal(-a.abs() - 1), 1),
    "exp_log": (lambda a: torch.log(torch.exp(a) + 1), 1),
    "log1p_expm1": (lambda a: torch.log1p(a.abs()) + torch.expm1(a), 1),
    "sqrt_rsqrt": (lambda a: torch.sqrt(a.abs()) + torch.rsqrt(a.abs() + 1),
                   1),
    "tanh_sigmoid": (lambda a: torch.tanh(a) * torch.sigmoid(a), 1),
    "erf_sin_cos": (lambda a: torch.erf(a) + torch.sin(a) - torch.cos(a), 1),
    "pow_scalar": (lambda a: a ** 3 + a.abs() ** 0.75 - a ** 2 + a ** -1,
                   1),
    "pow_swapped": (lambda a, b: 2.0 ** a + b.abs() ** a, 2),
    "gelu": (lambda a: F.gelu(a) - F.gelu(a, approximate="tanh"), 1),
    "gelu_by_hand": (lambda a: 0.5 * a * (1 + torch.tanh(
        0.7978845608 * (a + 0.044715 * a ** 3))), 1),
    "relu_silu": (lambda a: F.relu(a) + F.silu(a), 1),
    "clamp": (lambda a: torch.clamp(a, -0.5, 0.75) + a.clamp(min=0.1)
              + a.clamp(max=-0.2), 1),
    "max_min": (lambda a, b: torch.maximum(a, b) - 2 * torch.minimum(b, a),
                2),
    "compare": (lambda a, b: (a > b).float() + (a < b) * 2.0
                + 4 * (a >= 0.5).float() + 8 * (a <= b).float()
                + 16 * (a == b).float() + 32 * (a != 0.25).float(), 2),
    "where": (lambda a, b: torch.where(a > b, a - b, b * 2), 2),
    "where_scalar": (lambda a: torch.where(a > 0, a, 0.0), 1),
    "casts": (lambda a: a.to(torch.bfloat16).float() * 3 + a.half().float(),
              1),
    "three": (lambda a, b, c: a * b - c / 2, 3),
    "identity": (lambda a: a, 1),
    "like": (lambda a: torch.ones_like(a) * 2 + torch.zeros_like(a) + a, 1),
}


@pytest.mark.parametrize("name", list(FNS))
def test_codegen_ir_evaluates_to_fn(name):
    fn, n = FNS[name]
    xs = [torch.from_numpy(_rand(4, 33, seed=s)) for s in range(n)]
    if name == "compare":
        xs[1][0, :5] = xs[0][0, :5]          # some equal pairs
        xs[0][1, :3] = 0.25
    graph = CG.trace(fn, n)
    got = _ir_eval(graph, xs)
    ref = fn(*xs).float().expand(xs[0].shape)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    src = CG.elementwise_source(graph, [torch.float32] * n, torch.float32)
    assert "ptt_fn(" in src and f"kIn = {n};" in src


def test_codegen_source_is_stable_and_keyed_by_constants():
    one = CG.elementwise_source(CG.trace(lambda a, b: a * b + 1.0, 2),
                                [torch.bfloat16] * 2, torch.bfloat16)
    again = CG.elementwise_source(CG.trace(lambda a, b: a * b + 1.0, 2),
                                  [torch.bfloat16] * 2, torch.bfloat16)
    two = CG.elementwise_source(CG.trace(lambda a, b: a * b + 2.0, 2),
                                [torch.bfloat16] * 2, torch.bfloat16)
    other_out = CG.elementwise_source(CG.trace(lambda a, b: a * b + 1.0, 2),
                                      [torch.bfloat16] * 2, torch.float32)
    assert one == again and one != two and one != other_out
    assert "0x3f800000" in one and "0x40000000" in two
    red = CG.row_reduce_source(CG.trace(torch.maximum, 2), -np.inf,
                               torch.bfloat16)
    assert "0xff800000" in red and "ptt_kps::maximum" in red
    assert red == CG.row_reduce_source(CG.trace(torch.maximum, 2), -np.inf,
                                       torch.bfloat16)


def test_codegen_refuses_by_name():
    with pytest.raises(NotImplementedError, match="aten.sum"):
        CG.trace(lambda a: a - a.sum(), 1)
    with pytest.raises(NotImplementedError, match="aten.cumsum"):
        CG.trace(lambda a: torch.cumsum(a, 0), 1)
    w = torch.ones(2, 8)
    with pytest.raises(NotImplementedError, match="tensor constant"):
        CG.trace(lambda a: a * w, 1)
    with pytest.raises(NotImplementedError, match="int64"):
        CG.elementwise_source(CG.trace(torch.tanh, 1), [torch.int64],
                              torch.float32)
    with pytest.raises(NotImplementedError, match="float64"):
        CG.row_reduce_source(CG.trace(torch.add, 2), 0.0, torch.float64)
    with pytest.raises(NotImplementedError, match="int32"):
        CG.trace(lambda a: a.to(torch.int32), 1)
    with pytest.raises(NotImplementedError, match="2 outputs"):
        CG.trace(lambda a: (a, a), 1)
