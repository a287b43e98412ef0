"""CUDA code generation for the tile primitives' caller-given functions
(``kernels/primitives.py`` ``elementwise`` and ``row_reduce``).

Pallas compiles the caller's ``fn`` into the kernel body. The port does the
same ahead of the launch:

1. ``trace`` runs ``fn`` under ``torch.fx.experimental.proxy_tensor.make_fx``
   on small fp32 CPU stand-ins (the kernels compute in fp32, as the plain
   versions do on fp32 upcasts) and lowers the aten graph to a small IR,
   a ``Graph`` of ``Node``s over a closed op set (``OPS``);
2. ``emit_fn`` turns the IR into one inline ``__device__`` function of fp32
   arguments, each op with the round-to-nearest intrinsics PyTorch's own
   kernels round with (no FMA contraction), so the kernel follows the plain
   version op by op;
3. ``elementwise_source`` / ``row_reduce_source`` wrap it in the templates
   ``csrc/kps_elementwise.cuh`` / ``csrc/kps_row_reduce.cuh`` with the
   operands' element types, and ``library`` builds one shared library per
   distinct source (``_build.build_generated``) and loads it once.

An op outside the set, a tensor that ``fn`` captures (a constant that is not
a Python scalar), more than one output, and an operand outside float32 /
bfloat16 / float16 raise ``NotImplementedError`` naming what it met. The
cache key is the source text, which holds the IR, the operand dtypes and
the output dtype: two functions that differ only in a constant are two
kernels. Nothing is traced, generated or compiled at import time.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple, Union

import torch

__all__ = ["Node", "Graph", "OPS", "CUDA_TYPE", "trace", "emit_fn",
           "elementwise_source", "row_reduce_source", "library"]

CUDA_TYPE = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
             torch.float16: "__half"}
MAX_INPUTS = 16       # csrc/kps_elementwise.cuh kMaxIn

Arg = Union[str, float]   # "x<i>" (an input), "v<j>" (a node), a constant


@dataclass(frozen=True)
class Node:
    """``name = op(*args)``; ``attr`` is gelu's ``approximate`` or a round's
    dtype name."""
    name: str
    op: str
    args: Tuple[Arg, ...]
    attr: str = ""


@dataclass(frozen=True)
class Graph:
    """The lowered ``fn``: nodes in program order over inputs x0..x{n-1};
    ``out`` names an input or a node."""
    n_inputs: int
    nodes: Tuple[Node, ...]
    out: str

    @property
    def text(self) -> str:
        lines = [f"inputs {self.n_inputs}"]
        for n in self.nodes:
            args = ", ".join(a if isinstance(a, str) else repr(a)
                             for a in n.args)
            attr = f" [{n.attr}]" if n.attr else ""
            lines.append(f"{n.name} = {n.op}({args}){attr}")
        lines.append(f"out {self.out}")
        return "\n".join(lines)


# op -> number of operands; the emitted fp32 expression is in _EMIT
OPS: Dict[str, int] = {
    "const": 1,
    "add": 2, "sub": 2, "mul": 2, "div": 2, "pow": 2,
    "maximum": 2, "minimum": 2,
    "gt": 2, "lt": 2, "ge": 2, "le": 2, "eq": 2, "ne": 2,
    "where": 3,
    "neg": 1, "abs": 1, "reciprocal": 1, "exp": 1, "log": 1, "log1p": 1,
    "expm1": 1, "sqrt": 1, "rsqrt": 1, "tanh": 1, "sigmoid": 1, "erf": 1,
    "sin": 1, "cos": 1, "relu": 1, "silu": 1, "gelu": 1, "round": 1,
}

_BINARY = {"mul", "maximum", "minimum", "gt", "lt", "ge", "le", "eq", "ne",
           "pow"}
_UNARY = {"neg", "abs", "reciprocal", "exp", "log", "log1p", "expm1", "sqrt",
          "rsqrt", "tanh", "sigmoid", "erf", "sin", "cos", "relu", "silu"}
_IDENTITY = {"clone", "alias", "detach"}
_CONST_LIKE = {"zeros_like": 0.0, "ones_like": 1.0}
_ROUND = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


class _Lowering:
    def __init__(self, n_inputs):
        self.n_inputs = n_inputs
        self.nodes = []

    def add(self, op, *args, attr=""):
        name = f"v{len(self.nodes)}"
        self.nodes.append(Node(name, op, tuple(args), attr))
        return name


def _scalar(v, what):
    if isinstance(v, (int, float)):     # bool included
        return float(v)
    raise NotImplementedError(f"elementwise codegen: {what} takes a Python "
                              f"scalar here, got {type(v).__name__}")


def _lower_node(lw, node, ref):
    """Append the IR of one call_function node; returns its value (a ref or
    a constant)."""
    target = node.target
    full = str(target)                      # e.g. "aten.mul.Tensor"
    base = getattr(getattr(target, "overloadpacket", None), "__name__",
                   full)
    kw = dict(node.kwargs)
    args = [ref(a) if isinstance(a, torch.fx.Node) else a for a in node.args]

    def val(a):
        return a if isinstance(a, str) else _scalar(a, full)

    if base in ("add", "sub", "rsub"):
        a, b = args[0], args[1]
        alpha = args[2] if len(args) > 2 else kw.pop("alpha", 1)
        if base == "rsub":
            a, b = b, a
            if alpha != 1:
                b = lw.add("mul", val(b), _scalar(alpha, full))
        elif alpha != 1:
            b = lw.add("mul", val(b), _scalar(alpha, full))
        return lw.add("add" if base == "add" else "sub", val(a), val(b))
    if base == "div":
        if kw.get("rounding_mode") is not None:
            raise NotImplementedError(f"elementwise codegen: {full} with "
                                      f"rounding_mode={kw['rounding_mode']}")
        return lw.add("div", val(args[0]), val(args[1]))
    if base in _BINARY:
        if len(args) != 2:
            raise NotImplementedError(f"elementwise codegen: {full} with "
                                      f"{len(args)} operands")
        return lw.add(base, val(args[0]), val(args[1]))
    if base in _UNARY:
        return lw.add(base, val(args[0]))
    if base == "gelu":
        approx = args[1] if len(args) > 1 else kw.get("approximate", "none")
        return lw.add("gelu", val(args[0]), attr=approx)
    if base in ("clamp", "clamp_min", "clamp_max"):
        x = val(args[0])
        lo = args[1] if len(args) > 1 else kw.get("min")
        hi = args[2] if len(args) > 2 else kw.get("max")
        if base == "clamp_max":
            lo, hi = None, lo
        if lo is not None:
            x = lw.add("maximum", x, val(lo))
        if hi is not None:
            x = lw.add("minimum", x, val(hi))
        return x
    if base == "where":
        return lw.add("where", *(val(a) for a in args[:3]))
    if base in ("_to_copy", "convert_element_type", "to"):
        dtype = kw.get("dtype", args[1] if len(args) > 1 else None)
        x = val(args[0])
        if dtype is None or dtype in (torch.float32, torch.float64):
            return x
        if dtype in _ROUND:
            return lw.add("round", x, attr=_ROUND[dtype])
        if dtype == torch.bool:
            return lw.add("ne", x, 0.0)
        raise NotImplementedError(f"elementwise codegen: {full} to {dtype} "
                                  f"(float casts only)")
    if base in _IDENTITY:
        return val(args[0])
    if base in _CONST_LIKE:
        return lw.add("const", _CONST_LIKE[base])
    if base == "full_like":
        return lw.add("const", _scalar(args[1], full))
    if base == "scalar_tensor":
        return lw.add("const", _scalar(args[0], full))
    if base == "lift_fresh_copy":
        raise NotImplementedError("elementwise codegen: fn captures a tensor "
                                  "constant (pass it as an operand)")
    raise NotImplementedError(f"elementwise codegen: {full} is outside the "
                              f"op set")


def trace(fn: Callable, n_inputs: int) -> Graph:
    """Lower ``fn`` of ``n_inputs`` same-shaped tensors to the IR, traced on
    fp32 CPU stand-ins."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if not 1 <= n_inputs <= MAX_INPUTS:
        raise NotImplementedError(f"elementwise codegen: {n_inputs} operands "
                                  f"(1 to {MAX_INPUTS})")
    stand_ins = [torch.zeros(2, 8) for _ in range(n_inputs)]
    # through a varargs wrapper: make_fx reads a Python fn's own signature,
    # and one with defaults (F.relu's inplace) would ask for more inputs
    gm = make_fx(lambda *xs: fn(*xs))(*stand_ins)
    lw = _Lowering(n_inputs)
    env: Dict[torch.fx.Node, Arg] = {}
    placeholders = 0
    out = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = f"x{placeholders}"
            placeholders += 1
        elif node.op == "get_attr":
            raise NotImplementedError(
                f"elementwise codegen: fn captures a tensor constant "
                f"({node.target}; pass it as an operand)")
        elif node.op == "call_function":
            env[node] = _lower_node(lw, node, env.__getitem__)
        elif node.op == "output":
            res = node.args[0]
            if isinstance(res, (tuple, list)):
                if len(res) != 1:
                    raise NotImplementedError(
                        f"elementwise codegen: fn returns {len(res)} "
                        f"outputs (one)")
                res = res[0]
            if not isinstance(res, torch.fx.Node):
                raise NotImplementedError("elementwise codegen: fn returns "
                                          "no tensor")
            out = env[res]
        else:
            raise NotImplementedError(f"elementwise codegen: fx node "
                                      f"{node.op} {node.target}")
    if not isinstance(out, str):          # a constant result
        out = lw.add("const", out)
    return Graph(n_inputs, tuple(lw.nodes), out)


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------
def _literal(v: float) -> str:
    """The fp32 value of a constant, bit for bit (PyTorch rounds a Python
    scalar to the op's fp32 compute type)."""
    bits = struct.unpack("<I", struct.pack("<f", v))[0]
    return f"__int_as_float(0x{bits:08x}) /* {v!r} */"


def _pow(a, b, consts):
    e = consts.get(b)
    if e == 2.0:
        return f"__fmul_rn({a}, {a})"
    if e == 3.0:
        return f"__fmul_rn(__fmul_rn({a}, {a}), {a})"
    if e == 0.5:
        return f"__fsqrt_rn({a})"
    if e == 1.0:
        return a
    if e == -1.0:
        return f"__frcp_rn({a})"
    return f"powf({a}, {b})"


_EMIT = {
    "add": "__fadd_rn({0}, {1})", "sub": "__fsub_rn({0}, {1})",
    "mul": "__fmul_rn({0}, {1})", "div": "__fdiv_rn({0}, {1})",
    "maximum": "ptt_kps::maximum({0}, {1})",
    "minimum": "ptt_kps::minimum({0}, {1})",
    "gt": "({0} > {1} ? 1.f : 0.f)", "lt": "({0} < {1} ? 1.f : 0.f)",
    "ge": "({0} >= {1} ? 1.f : 0.f)", "le": "({0} <= {1} ? 1.f : 0.f)",
    "eq": "({0} == {1} ? 1.f : 0.f)", "ne": "({0} != {1} ? 1.f : 0.f)",
    "where": "({0} != 0.f ? {1} : {2})",
    "neg": "(-{0})", "abs": "fabsf({0})", "reciprocal": "__frcp_rn({0})",
    "exp": "expf({0})", "log": "logf({0})", "log1p": "log1pf({0})",
    "expm1": "expm1f({0})", "sqrt": "__fsqrt_rn({0})",
    "rsqrt": "rsqrtf({0})", "tanh": "tanhf({0})",
    "sigmoid": "ptt_kps::sigmoid({0})", "erf": "erff({0})",
    "sin": "sinf({0})", "cos": "cosf({0})", "relu": "ptt_kps::relu({0})",
    "silu": "ptt_kps::silu({0})",
}


def emit_fn(graph: Graph, name: str = "ptt_fn") -> str:
    """``__device__ __forceinline__ float name(float x0, ...)``: the IR as
    fp32 statements, one per node."""
    params = ", ".join(f"float x{i}" for i in range(graph.n_inputs))
    lines = [f"__device__ __forceinline__ float {name}({params}) {{"]
    consts: Dict[str, float] = {}

    def arg(a):
        if isinstance(a, str):
            return a
        lit = _literal(a)
        consts[lit] = float(torch.tensor(a, dtype=torch.float32))
        return lit

    for n in graph.nodes:
        if len(n.args) != OPS[n.op]:
            raise NotImplementedError(f"elementwise codegen: {n.op} with "
                                      f"{len(n.args)} operands")
        a = [arg(x) for x in n.args]
        if n.op == "const":
            expr = a[0]
        elif n.op == "pow":
            expr = _pow(a[0], a[1], consts)
        elif n.op == "gelu":
            if n.attr not in ("none", "tanh"):
                raise NotImplementedError(f"elementwise codegen: gelu "
                                          f"approximate={n.attr!r}")
            expr = f"ptt_kps::gelu_{n.attr}({a[0]})"
        elif n.op == "round":
            expr = f"ptt_kps::round_{n.attr}({a[0]})"
        else:
            expr = _EMIT[n.op].format(*a)
        lines.append(f"  const float {n.name} = {expr};")
    lines.append(f"  return {graph.out};")
    lines.append("}")
    return "\n".join(lines)


def _cuda_type(dtype, what) -> str:
    t = CUDA_TYPE.get(dtype)
    if t is None:
        raise NotImplementedError(f"{what}: {dtype} operands (the generated "
                                  f"kernels take float32, bfloat16 or "
                                  f"float16)")
    return t


def _header(kind, graph, types):
    ir = "\n".join("//   " + line for line in graph.text.splitlines())
    return (f"// Generated by paddle_tpu_torch/kernels/_codegen.py: the tile "
            f"primitive {kind}\n// over {', '.join(types)}, fn as IR:\n{ir}\n")


def elementwise_source(graph: Graph, in_dtypes: Sequence[torch.dtype],
                       out_dtype: torch.dtype) -> str:
    """The CUDA source of ``elementwise`` for ``graph`` over operands of
    ``in_dtypes`` into ``out_dtype``: ``ptt_kps_elementwise`` (see
    ``csrc/kps_elementwise.cuh``)."""
    if len(in_dtypes) != graph.n_inputs:
        raise ValueError(f"{len(in_dtypes)} dtypes for {graph.n_inputs} "
                         f"inputs")
    ins = [_cuda_type(d, "elementwise") for d in in_dtypes]
    out = _cuda_type(out_dtype, "elementwise")
    sizes = [torch.tensor([], dtype=d).element_size()
             for d in (*in_dtypes, out_dtype)]
    vec = 16 // min(sizes)                 # elements a thread a step
    n = graph.n_inputs
    loads = "\n".join(
        f"    ptt_kps::load_vec<kVec>(static_cast<const {t}*>(in.p[{k}]), i, "
        f"a{k});" for k, t in enumerate(ins))
    ones = ", ".join(f"ptt::to_f32(static_cast<const {t}*>(in.p[{k}])[e])"
                     for k, t in enumerate(ins))
    return f"""{_header("elementwise", graph, ins + ['-> ' + out])}
#include "kps_elementwise.cuh"

namespace {{

{emit_fn(graph)}

struct Gen {{
  static constexpr int kIn = {n};
  static constexpr int kVec = {vec};
  using Out = {out};
  __device__ static void vec(const ptt_kps::Ptrs& in, void* out, long long i) {{
    float {", ".join(f"a{k}[kVec]" for k in range(n))}, y[kVec];
{loads}
#pragma unroll
    for (int k = 0; k < kVec; ++k) y[k] = ptt_fn({", ".join(f"a{k}[k]" for k in range(n))});
    ptt_kps::store_vec<kVec>(static_cast<Out*>(out), i, y);
  }}
  __device__ static void one(const ptt_kps::Ptrs& in, void* out, long long e) {{
    static_cast<Out*>(out)[e] = ptt::from_f32<Out>(ptt_fn({ones}));
  }}
}};

}}  // namespace

extern "C" int ptt_kps_elementwise(const void* const* ins, int n_in, void* out, long long n,
                                   void* stream) {{
  return ptt_kps::launch_elementwise<Gen>(ins, n_in, out, n, stream);
}}

extern "C" const char* ptt_kps_error_string(int code) {{
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}}
"""


def row_reduce_source(graph: Graph, identity: float,
                      in_dtype: torch.dtype) -> str:
    """The CUDA source of ``row_reduce`` for the binary ``graph`` with
    ``identity`` over rows of ``in_dtype``: ``ptt_kps_row_reduce`` (see
    ``csrc/kps_row_reduce.cuh``)."""
    if graph.n_inputs != 2:
        raise NotImplementedError(f"row_reduce codegen: fn takes "
                                  f"{graph.n_inputs} operands (two)")
    t = _cuda_type(in_dtype, "row_reduce")
    return f"""{_header("row_reduce", graph, [t])}//   identity {identity!r}
#include "kps_row_reduce.cuh"

namespace {{

{emit_fn(graph)}

struct Gen {{
  using In = {t};
  __device__ static float identity() {{ return {_literal(float(identity))}; }}
  __device__ static float fn(float a, float b) {{ return ptt_fn(a, b); }}
}};

}}  // namespace

extern "C" int ptt_kps_row_reduce(const void* x, void* out, long long rows, int C,
                                  void* stream) {{
  return ptt_kps::launch_row_reduce<Gen>(x, out, rows, C, stream);
}}

extern "C" const char* ptt_kps_error_string(int code) {{
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}}
"""


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
_ARGTYPES = {
    # ins (array of pointers), n_in, out, n, stream
    "ptt_kps_elementwise": [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_longlong, ctypes.c_void_p],
    # x, out, rows, C, stream
    "ptt_kps_row_reduce": [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one generated source (built at first use,
    cached by the source's text), its entry points declared."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    from ._build import build_generated
    lib = ctypes.CDLL(str(build_generated(source)))
    for name, argtypes in _ARGTYPES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.ptt_kps_error_string.argtypes = [ctypes.c_int]
    lib.ptt_kps_error_string.restype = ctypes.c_char_p
    _LIBS[source] = lib
    return lib
