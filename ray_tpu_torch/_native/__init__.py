"""Native code of the port: the CUDA kernels (``build.py``, nvcc) and the
host-side C++ ring channel (this module, g++).

``ring_channel.cpp`` is a CPython extension (atomics and GIL-released
waits) behind ``experimental/channel/shm_channel.py``'s default backend.
It is compiled with ``g++`` at first use into
``build/ray_tpu_torch/_ring_native_<hash>.so`` at the root of the
checkout, keyed by a hash of the source and the Python version, so a
fresh checkout pays one build of a few seconds and every process after
that loads the cached library. A failed build raises with the compiler's
output: there is no fallback. The numpy ring is used only when a channel
asks for it (``backend="py"``, or ``RAY_TPU_TORCH_DISABLE_NATIVE=1`` for
the default).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

from .build import BUILD_DIR

_SRC_DIR = Path(__file__).resolve().parent
_lock = threading.Lock()
_ring_mod = None


def build_extension(mod_name: str, src: Path, out_dir: Path = BUILD_DIR) -> Path:
    """Compile the CPython extension ``src`` with g++ into ``out_dir``;
    return the .so path. Raises RuntimeError with g++'s output when the
    build fails."""
    tag = hashlib.sha256(src.read_bytes() + sys.version.encode()).hexdigest()[:16]
    so_path = out_dir / f"{mod_name}_{tag}.so"
    if so_path.exists():
        return so_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{so_path.name}.tmp.{os.getpid()}"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", str(src), "-o", str(tmp), "-lrt"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build of {src.name} failed ({' '.join(cmd)}): {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build of {src.name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)  # atomic: concurrent builders race safely
    return so_path


def _load(mod_name: str, so_path: Path):
    spec = importlib.util.spec_from_file_location(mod_name, so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ring_native():
    """The ``_ring_native`` extension module, built on first use."""
    global _ring_mod
    with _lock:
        if _ring_mod is None:
            _ring_mod = _load("_ring_native",
                              build_extension("_ring_native", _SRC_DIR / "ring_channel.cpp"))
        return _ring_mod
