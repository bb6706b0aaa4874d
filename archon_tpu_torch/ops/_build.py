"""Build and load the CUDA kernels of ``archon_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes`` -- seconds to build,
where a PyTorch C++ extension takes minutes.  The build happens at first use,
from the repository's own sources only, into ``build/kernels/`` at the
repository root (git-ignored), so the port runs from a checkout (or an
editable install).  The file name carries a hash of the sources
and flags, the way ``archon_tpu/native.py`` keys its host library, so an edit
rebuilds and a stale library is never loaded.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = ""  # nvcc/ptxas output of the build this process ran ("" if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call.  Thread-safe: a
    concurrent first caller waits for the build instead of seeing none."""
    with _LOCK:
        if _LIB is None:
            _load()
        return _LIB


def _load() -> None:
    global _LIB, BUILD_LOG
    srcs = sorted(_CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {_CSRC}: run the port from a checkout")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode() + s.read_bytes())
    out = BUILD_DIR / f"archon_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.archon_sort_tiles.restype = ctypes.c_int
    lib.archon_sort_tiles.argtypes = [ptr, i64, ctypes.c_int, ptr, i64, ptr]
    lib.archon_merge_level.restype = ctypes.c_int
    lib.archon_merge_level.argtypes = [ptr, i64, ctypes.c_int, ptr, ptr, i64, i64, ptr]
    _LIB = lib
