"""Build of the port's CUDA kernels: ``nvcc`` by hand into one shared
library with a plain C interface, loaded with ``ctypes``.

The ``*.cu`` sources under ``paddle_tpu_torch/csrc/`` are compiled for
``sm_90a``, one ``nvcc -c`` per source (the flash kernels' sources and the
ragged wgmma kernels once per width, the 16-bit ragged one also once per
page ring), all started together, and linked by
one ``nvcc -shared`` into
``paddle_tpu_torch/_build/<hash>/libpaddle_tpu_torch_kernels.so``, where the
hash covers the sources, the headers and the flags, so a checkout builds at
first use and reuses the library after that. The ``.cuh`` templates of the
tile primitives are not compiled on their own: ``build_generated`` builds
one small library per source that ``kernels/_codegen.py`` generates from a
caller's function, under ``paddle_tpu_torch/_build/gen/<hash>/``, with the
same ``nvcc`` and flags. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["load_library", "build_library", "build_generated",
           "build_generated_many", "check", "launch", "is_cpu", "dtype_code",
           "check_rows", "zeroed_counters", "BUILD_LOG", "GEN_LOG"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpaddle_tpu_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v"]

# the flash kernels' head-dim family (csrc/flash_common.cuh kDPads): the
# widths a head is padded to (D_pad 32 and 96 read into 64 and 128)
FLASH_D_PADS = (32, 64, 96, 128, 192, 256)
# the flash kernels' sources, the forward, dQ and dK/dV in bf16 / fp16
# (flash_fwd_hopper.cu, flash_dq_hopper.cu, flash_dkv_hopper.cu) and in fp32
# on the TF32 tensor cores (flash_*_tf32_hopper.cu): one object each per
# width (-DPTT_FLASH_D=<width>)
FLASH_HOPPER_D_PADS = (64, 128, 192, 256)
# the 16-bit ragged kernel (ragged_paged_attention_hopper.cu): one object per
# width and page ring (-DPTT_RAGGED_D=<width> -DPTT_RAGGED_GATHER=<0: TMA,
# 1: gathered>; the object of 64 with the TMA ring holds the host entries)
RAGGED_HOPPER_D_PADS = (64, 128, 192, 256)
# the fp32 ragged kernel on the TF32 tensor cores
# (ragged_paged_attention_tf32_hopper.cu, its pages always gathered): one
# object per width (-DPTT_RAGGED_TF32_D=<width>; 64 holds the host entries)
RAGGED_TF32_D_PADS = (64, 128, 192, 256)

_LIB: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register / shared-memory / spill
# lines) and how long it took; empty when the library came from the cache
BUILD_LOG = {"seconds": 0.0, "output": "", "cached": True, "path": ""}
# the same for each generated library, by its path
GEN_LOG: Dict[str, dict] = {}
GEN_LIB_NAME = "libptt_generated.so"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from paddle_tpu_torch/csrc at "
                           "first use")
    return found


def _units():
    """(source, object stem, extra flags): one per source, one per width
    for the flash sources, one per width and page ring for the 16-bit
    ragged wgmma kernel and one per width for the TF32 one."""
    for src in sorted(CSRC.glob("*.cu")):
        if src.name.startswith("flash_") and src.name.endswith("_hopper.cu"):
            for d in FLASH_HOPPER_D_PADS:
                yield src, f"{src.stem}.d{d}", [f"-DPTT_FLASH_D={d}"]
        elif src.name == "ragged_paged_attention_hopper.cu":
            for d in RAGGED_HOPPER_D_PADS:
                for ring, gather in (("tma", 0), ("gather", 1)):
                    yield src, f"{src.stem}.d{d}.{ring}", [
                        f"-DPTT_RAGGED_D={d}",
                        f"-DPTT_RAGGED_GATHER={gather}"]
        elif src.name == "ragged_paged_attention_tf32_hopper.cu":
            for d in RAGGED_TF32_D_PADS:
                yield src, f"{src.stem}.d{d}", [f"-DPTT_RAGGED_TF32_D={d}"]
        else:
            yield src, src.stem, []


def _digest(extra: str = "") -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")) + sorted(CSRC.glob("*.h")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    pads = (FLASH_D_PADS + FLASH_HOPPER_D_PADS + RAGGED_HOPPER_D_PADS
            + RAGGED_TF32_D_PADS)
    h.update(" ".join(NVCC_FLAGS + list(map(str, pads))).encode())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def _run_all(cmds: Sequence[List[str]], limit: int) -> List[str]:
    """Run the commands, at most ``limit`` at a time; their outputs in order.
    A failure raises and stops the rest."""
    procs, outputs = {}, [""] * len(cmds)
    pending = list(enumerate(cmds))
    try:
        while pending or procs:
            while pending and len(procs) < limit:
                i, cmd = pending.pop(0)
                procs[i] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)
            i = next(iter(procs))
            out, _ = procs[i].communicate()
            code = procs.pop(i).returncode
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}): "
                                   f"{' '.join(cmds[i])}\n{out}")
            outputs[i] = out
    finally:
        for proc in procs.values():   # a failed source stops the rest
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outputs


def build_library() -> Path:
    """Compile (if needed) and return the shared library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    BUILD_LOG["path"] = str(lib)
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    objs, cmds = [], []
    for src, stem, extra in _units():
        objs.append(out_dir / f"{stem}.{pid}.o")
        cmds.append([nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o",
                     str(objs[-1])])
    outputs = _run_all(cmds, len(cmds))
    tmp = out_dir / (LIB_NAME + f".tmp{pid}")
    cmd = [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    BUILD_LOG.update(seconds=time.perf_counter() - t0,
                     output="\n".join(outputs + [res.stdout]), cached=False)
    return lib


def _generated_path(source: str) -> Path:
    return BUILD_ROOT / "gen" / _digest(source) / GEN_LIB_NAME


def build_generated_many(sources: Sequence[str]) -> List[Path]:
    """Compile (if needed) each generated source into its own shared
    library, all at once (at most two ``nvcc`` a core), and return their
    paths. A library's path hashes its source, the headers and the flags;
    each is written under a temporary name and renamed into place, so a
    concurrent loader never sees half a file."""
    paths = [_generated_path(src) for src in sources]
    todo = [(src, lib) for lib, src in dict(zip(paths, sources)).items()
            if not lib.exists()]
    for lib in paths:
        if lib.exists() and str(lib) not in GEN_LOG:
            GEN_LOG[str(lib)] = {"seconds": 0.0, "output": "",
                                 "cached": True, "path": str(lib)}
    if not todo:
        return paths
    nvcc, pid = _nvcc(), os.getpid()
    cmds, tmps = [], []
    for src, lib in todo:
        lib.parent.mkdir(parents=True, exist_ok=True)
        cu = lib.parent / "generated.cu"
        cu.write_text(src)
        tmps.append(lib.parent / f"{GEN_LIB_NAME}.tmp{pid}")
        cmds.append([nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-shared", str(cu), "-o",
                     str(tmps[-1])])
    t0 = time.perf_counter()
    outputs = _run_all(cmds, 2 * (os.cpu_count() or 1))
    seconds = time.perf_counter() - t0
    for (_, lib), tmp, out in zip(todo, tmps, outputs):
        os.replace(tmp, lib)
        GEN_LOG[str(lib)] = {"seconds": seconds, "output": out,
                             "cached": False, "path": str(lib),
                             "batch": len(todo)}
    return paths


def build_generated(source: str) -> Path:
    """``build_generated_many`` of one source."""
    return build_generated_many([source])[0]


def load_library() -> ctypes.CDLL:
    """Build at first use, load once, and declare every C entry point's
    argument types (``c_void_p`` for pointers and the stream, or ctypes
    would cut a pointer to 32 bits)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    ll = ctypes.c_longlong
    cu = ctypes.c_uint
    drop = [ci, cu, cu, cu, cf]   # drop, seed0, seed1, thresh, drop_scale
    signatures = {
        # q, k, v, tables, q_lens, kv_lens, out, k_scales, v_scales,
        # part_o, part_ml, R, C, Hq, Hkv, NB, bs, D, nb, splits, scale,
        # dtype, pool_dtype, stream
        "ptt_ragged_paged_attention": [vp] * 11 + [ci] * 9 + [cf, ci, ci, vp],
        # R, C, Hq, Hkv, bs, D, nb, dtype, pool_dtype, aligned, out[4]
        "ptt_ragged_plan": [ci] * 10 + [ctypes.POINTER(ci)],
        # q, k, v, tables, lens, out, part, tickets, B, Hq, Hkv, NB, bs, D,
        # nb, q strides (batch, head), splits, scale, dtype, stream
        "ptt_paged_decode_attention": [vp] * 8 + [ci] * 7 + [ll, ll]
        + [ci, cf, ci, vp],
        # B, Hq, Hkv, bs, D, nb, dtype, aligned, out[5]
        "ptt_paged_decode_plan": [ci] * 8 + [ctypes.POINTER(ci)],
        # q, k, v, bias (or null), qseg, kseg, fms, fme (or null), out,
        # lse, strides (13), B, Sq, Sk, H, Hkv, D, scale, causal, drop,
        # seed0, seed1, thresh, drop_scale, dtype, bias_dtype, fm_hs,
        # win_left, win_right, stream
        "ptt_flash_fwd": [vp] * 10 + [strides] + [ci] * 6 + [cf, ci] + drop
        + [ci] * 5 + [vp],
        # q, k, v, dO, lse, delta, dq, bias, dbias, qseg, kseg, fms, fme,
        # strides (16), ...
        "ptt_flash_bwd_dq": [vp] * 13 + [strides] + [ci] * 6 + [cf, ci]
        + drop + [ci] * 5 + [vp],
        # q, k, v, dO, lse, delta, dk, dv, bias, qseg, kseg, fms, fme,
        # strides (16), ...
        "ptt_flash_bwd_dkv": [vp] * 13 + [strides] + [ci] * 6 + [cf, ci]
        + drop + [ci] * 5 + [vp],
        # kernel (0 forward, 1 dQ, 2 dK/dV), D, dtype, bias, out[4]
        "ptt_flash_plan": [ci] * 4 + [ctypes.POINTER(ci)],
        # x, w, b (or null), y, mean, rstd, rows, H, eps, dtype, stream
        "ptt_layer_norm_fwd": [vp] * 6 + [ll, ci, cf, ci, vp],
        # rows, H, dtype, aligned, out[2]
        "ptt_layer_norm_fwd_plan": [ll, ci, ci, ci, ctypes.POINTER(ci)],
        # x, w, mean, rstd, dy, dx (or null), sums (or null), part, sync,
        # rows, H, need_dw, need_db, part_rows, dtype, stream
        "ptt_layer_norm_bwd": [vp] * 9 + [ll] + [ci] * 5 + [vp],
        # rows, H, dtype, aligned, need_dw, need_db, out[2]
        "ptt_layer_norm_bwd_plan": [ll] + [ci] * 5 + [ctypes.POINTER(ci)],
        # x, w, y, rstd, rows, H, eps, dtype, stream
        "ptt_rms_norm_fwd": [vp] * 4 + [ll, ci, cf, ci, vp],
        # rows, H, dtype, aligned, out[2]
        "ptt_rms_norm_fwd_plan": [ll, ci, ci, ci, ctypes.POINTER(ci)],
        # x, w, rstd, dy, dx (or null), dw (or null), part, sync, rows, H,
        # part_rows, dtype, stream
        "ptt_rms_norm_bwd": [vp] * 8 + [ll, ci, ci, ci, vp],
        # rows, H, dtype, aligned, out[2]
        "ptt_rms_norm_bwd_plan": [ll, ci, ci, ci, ctypes.POINTER(ci)],
        # x, cos, sin, y, B, S, H, D, strides (b, s, h), neg_sin, dtype,
        # stream
        "ptt_rope": [vp] * 4 + [ci] * 4 + [ll] * 3 + [ci, ci, vp],
        # p, g, m1, m2, master, n, p / g / m1 / m2 dtypes, lr, c1, c2, b1,
        # 1-b1, b2, 1-b2, eps, l2, dec, sr, seed0, seed1, the shard's
        # window (inner, per, full, start), stream
        "ptt_fused_adam": [vp] * 5 + [ll] + [ci] * 4 + [cf] * 10
        + [ci, cu, cu] + [ll] * 4 + [vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    lib.ptt_error_string.argtypes = [ci]
    lib.ptt_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(code: int, what: str, error_string=None) -> None:
    """Raise on a non-zero CUDA status returned by a C entry point
    (``error_string``: the library's own, for a generated one)."""
    if code != 0:
        err = error_string or load_library().ptt_error_string
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({err(code).decode()})")


def launch(what: str, fn, device, *args, error_string=None) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream, then raise on a
    non-zero CUDA status (``what`` names the call in the error)."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    check(code, what, error_string)


_COUNTERS: Dict[tuple, object] = {}


def zeroed_counters(owner: str, device, n: int = 1):
    """int32 counters for a kernel that counts its finished blocks (a merge
    ticket, a grid barrier) and sets them back to 0 before it ends: one
    buffer of at least ``n`` per (owner, device, current stream), made with
    zeros and grown (with new zeros) when a call needs more. Calls that
    share a buffer run on one stream, so they never overlap."""
    import torch
    key = (owner, device, torch.cuda.current_stream(device).cuda_stream)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        t = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def is_cpu(t, what: str) -> bool:
    """True for a CPU tensor (the caller takes its plain version), False for
    a CUDA one (the caller launches its kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def dtype_code(t, what: str) -> int:
    """The C entries' dtype argument (``csrc/dtypes.cuh``): 0 for float32, 1
    for bfloat16, 2 for float16."""
    import torch
    code = {torch.float32: 0, torch.bfloat16: 1,
            torch.float16: 2}.get(t.dtype)
    if code is None:
        raise TypeError(f"{what} kernels take float32, bfloat16 or float16, "
                        f"got {t.dtype}")
    return code


def check_rows(x2, what: str, *more) -> int:
    """A row kernel's input: contiguous ``[rows, H]`` float32, bfloat16 or
    float16, with ``more`` on its device. Returns the dtype code."""
    code = dtype_code(x2, what)
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError(f"{what} kernels take contiguous [rows, H], got "
                         f"{tuple(x2.shape)} strides {x2.stride()}")
    for t in more:
        if t.device != x2.device:
            raise ValueError(f"{what}: a tensor is on {t.device}, x on "
                             f"{x2.device}")
    return code
