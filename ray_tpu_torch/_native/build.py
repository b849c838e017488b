"""Build and load the port's hand-written CUDA kernels.

Every ``ray_tpu_torch/csrc/*.cu`` is compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, which is
loaded with ``ctypes``. The build runs at first use; its output lands in
``build/ray_tpu_torch/lib<hash>.so`` at the root of the checkout, keyed
by a hash of the sources and flags, so a changed source builds anew.
One ``nvcc`` per source runs in parallel; the objects are then linked.

Each C entry point returns ``cudaGetLastError()`` as an int; a wrapper
raises when that is not 0 (see ``check``). A failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures: every pointer and the stream are c_void_p (ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer).
SIGNATURES: Dict[str, List] = {
    "rtt_flash_attention_fwd": [
        _P, _P, _P, _P, _P,                 # q, k, v, o, lse
        _I, _I, _I, _I, _I, _I,             # B, S, T, H, KVH, hd
        _L, _L, _L,                         # q strides (b, s, h)
        _L, _L, _L,                         # k strides
        _L, _L, _L,                         # v strides
        _L, _L, _L,                         # o strides
        _F, _I, _P,                         # scale, causal, stream
    ],
    "rtt_fused_ce_fwd": [
        _P, _P, _P, _P, _P, _P,             # x, w, targets, partial, lse, tgt
        _I, _I, _I, _I, _P,                 # N, D, V, vocab tiles, stream
    ],
    "rtt_flash_attention_bwd_dkv": [
        _P, _P, _P, _P, _P, _P, _P, _P,     # q, k, v, dout, lse, delta, dk, dv
        _I, _I, _I, _I, _I, _I,             # B, S, T, H, KVH, hd
        _P, _F, _I, _P,                     # strides (18 long long), scale, causal, stream
    ],
    "rtt_flash_attention_bwd_dq": [
        _P, _P, _P, _P, _P, _P, _P,         # q, k, v, dout, lse, delta, dq
        _I, _I, _I, _I, _I, _I,             # B, S, T, H, KVH, hd
        _P, _F, _I, _P,                     # strides (18 long long), scale, causal, stream
    ],
    "rtt_fused_ce_bwd_dlog": [
        _P, _P, _P, _P, _P, _P,             # x, w, targets, lse, g, dlog
        _I, _I, _I, _P,                     # rows, D, V, stream
    ],
    "rtt_fused_ce_bwd_dx": [
        _P, _P, _P,                         # dlog, w, dx
        _I, _I, _I, _P,                     # rows, D, V, stream
    ],
    "rtt_fused_ce_bwd_dw": [
        _P, _P, _P, _P,                     # x, dlog, acc, dw
        _I, _I, _I, _I, _I, _P,             # rows, D, V, accumulate, last, stream
    ],
    "rtt_fused_adamw": [
        _P, _P, _P, _P, _P,                 # g, p, mu, nu, global norm
        _L, _I, _P, _P,                     # n, bf16, host scalars, stream
    ],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: str = ""          # nvcc/ptxas output of the build this process ran
build_seconds: float = 0.0   # 0.0 when the library was already built


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _run(cmds: List[List[str]]) -> str:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed ({' '.join(cmd)}):\n{out}")
    return "".join(outs)


def _build(out: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stage = BUILD_DIR / f"{out.stem}.{os.getpid()}"
    stage.mkdir(exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [stage / (s.stem + ".o") for s in srcs]
    log = _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(s), "-o", str(o)]
                for s, o in zip(srcs, objs)])
    tmp = stage / out.name
    log += _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                  *map(str, objs)]])
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(stage, ignore_errors=True)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            t0 = time.perf_counter()
            build_log = _build(path)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (launch refused,
    bad configuration, or an earlier asynchronous fault)."""
    if err != 0:
        what = library().rtt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({what})")
