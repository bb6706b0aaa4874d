"""ctypes bindings for the native host runtime (csrc/archon_host.cpp).

Compiled on demand with g++ into a cached shared library; every entry point
has a numpy fallback so the package works without a toolchain.  (The C ABI +
ctypes is the binding layer, as for the CUDA kernels.)

The port's own copy of ``archon_tpu/native.py``, on its own copy of the C++
source.  It differs from the original in three places only:

- the build is safe for threads and for processes.  One lock guards
  ``_build_lib`` and ``_TRIED`` is set after ``_LIB``, so a concurrent first
  caller waits for the library instead of seeing none.  The compiler writes
  to a temporary name in the target directory and ``os.replace`` puts the
  file in place, so no process ever opens a half-written library;
- it builds into the directory the CUDA kernels use (``ops/_build.BUILD_DIR``,
  under the checkout's git-ignored ``build/``), from the source in the
  package, at first use;
- ``unbwt_starts`` without a library walks with the port's own
  ``core/unbwt.bwt_inverse_with_starts`` on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np

from .ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "csrc" / "archon_host.cpp"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_lib():
    global _LIB, _TRIED
    if not _TRIED:
        with _LOCK:
            if not _TRIED:
                _LIB = _load(_compile())
                _TRIED = True
    return _LIB


def _compile() -> Path | None:
    """The library's path, compiling it first if no process has yet."""
    if not _SRC.exists():
        return None
    # ARCHON_NATIVE_DEBUG=1 builds the sanitizer variant (the ASAN/UBSAN-era
    # equivalent of the reference's debug/valgrind Makefile targets,
    # bwt/a7/Makefile:7-17, SURVEY section 4.4).  Because the .so is
    # dlopened into an uninstrumented python, run with
    #   LD_PRELOAD=$(g++ -print-file-name=libasan.so) ASAN_OPTIONS=detect_leaks=0
    debug = os.environ.get("ARCHON_NATIVE_DEBUG") == "1"
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    if debug:
        tag += "-dbg"
    out = BUILD_DIR / f"archon_host_{tag}.so"
    if out.exists():
        return out
    flags = (
        ["-g", "-O1", "-fsanitize=address,undefined",
         "-fno-omit-frame-pointer"]
        if debug
        else ["-O3", "-march=native"]
    )
    # a name of this process's own: racing processes each compile their own
    # file and the last rename wins, every one of them a whole library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
    cmd = [
        "g++", "-shared", "-fPIC", "-pthread", *flags,
        "-o", str(tmp), str(_SRC),
    ]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return None
    return out


def _load(out):
    if out is None:
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.archon_histogram256.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.archon_unbwt.restype = ctypes.c_int
    lib.archon_unbwt.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.archon_unbwt_starts.restype = ctypes.c_int
    lib.archon_unbwt_starts.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.archon_verify_cycle.restype = ctypes.c_int
    lib.archon_verify_cycle.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.archon_bitpack.restype = ctypes.c_int64
    lib.archon_bitpack.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.archon_bitunpack.restype = ctypes.c_int64
    lib.archon_bitunpack.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64]
    lib.archon_mtf_rle0.restype = ctypes.c_int64
    lib.archon_mtf_rle0.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.archon_unrle0_unmtf.restype = ctypes.c_int64
    lib.archon_unrle0_unmtf.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.archon_bitpack16.restype = ctypes.c_int64
    lib.archon_bitpack16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.archon_bitunpack16.restype = ctypes.c_int64
    lib.archon_bitunpack16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
    lib.archon_map_open.restype = ctypes.c_void_p
    lib.archon_map_open.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.archon_map_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.archon_map_data.argtypes = [ctypes.c_void_p]
    lib.archon_map_close.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    return _build_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def histogram256(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    lib = _build_lib()
    if lib is None:
        return np.bincount(data, minlength=256).astype(np.int64)
    out = np.zeros(256, np.int64)
    lib.archon_histogram256(_ptr(data), len(data), _ptr(out))
    return out


def unbwt(L: np.ndarray, base: int, sentinel_large: bool) -> np.ndarray:
    """Native serial LF chain walk (a6/src/bwt.c:459-478 semantics)."""
    L = np.ascontiguousarray(L, np.uint8)
    n = len(L)
    lib = _build_lib()
    if lib is None:
        from .golden.sa import bwt_inverse

        return bwt_inverse(L, base, "large" if sentinel_large else "small")
    P = np.empty(n, np.int32)
    out = np.empty(n, np.uint8)
    rc = lib.archon_unbwt(_ptr(L), n, base, int(sentinel_large), _ptr(P), _ptr(out))
    if rc != 0:
        raise ValueError("invalid BWT payload")
    return out


def unbwt_starts(L: np.ndarray, base: int, starts: np.ndarray) -> np.ndarray:
    """Native LF walk with caller-supplied bucket starts (the a6 'var'
    inverse: Huffman-code-ordered buckets; base-last roll).  Falls back to
    the port's pointer-doubling walk, on the CPU, when the toolchain is
    absent."""
    L = np.ascontiguousarray(L, np.uint8)
    n = len(L)
    lib = _build_lib()
    if lib is None:
        import torch

        from .core.unbwt import bwt_inverse_with_starts

        out = bwt_inverse_with_starts(
            torch.from_numpy(L.copy()), int(base),
            torch.from_numpy(np.ascontiguousarray(starts, np.int64)),
        )
        return out.numpy()
    st = np.ascontiguousarray(starts, np.int64)
    P = np.empty(n, np.int32)
    out = np.empty(n, np.uint8)
    rc = lib.archon_unbwt_starts(_ptr(L), n, base, _ptr(st), _ptr(P), _ptr(out))
    if rc != 0:
        raise ValueError("invalid BWT payload")
    return out


def verify_cycle(L: np.ndarray, base: int, sentinel_large: bool) -> bool:
    """True iff the LF walk over (L, base) is a single n-cycle."""
    L = np.ascontiguousarray(L, np.uint8)
    n = len(L)
    lib = _build_lib()
    if lib is None:
        seen = np.zeros(n, bool)
        from .golden.sa import bwt_inverse  # walk implicitly checks shape

        try:
            bwt_inverse(L, base, "large" if sentinel_large else "small")
        except Exception:
            return False
        return True
    P = np.empty(n, np.int32)
    seen = np.zeros(n, np.uint8)
    return lib.archon_verify_cycle(_ptr(L), n, base, int(sentinel_large), _ptr(P), _ptr(seen)) == 0


def bitpack(data: np.ndarray, code_values: np.ndarray, code_lengths: np.ndarray):
    """Native a6 bit-stream packer; returns (words u32, total_bits)."""
    data = np.ascontiguousarray(data, np.uint8)
    vals = np.ascontiguousarray(code_values, np.uint32)
    lens = np.ascontiguousarray(code_lengths, np.uint8)
    lib = _build_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    words = np.zeros(len(data) + 2, np.uint32)
    total = lib.archon_bitpack(_ptr(data), len(data), _ptr(vals), _ptr(lens), _ptr(words))
    return words, int(total)


def bitunpack(words: np.ndarray, total_bits: int, code_values, code_lengths, n: int):
    words = np.ascontiguousarray(words, np.uint32)
    # The native first-bits decoder issues 8-byte wide loads that may read up
    # to 8 bytes past the final bit; guarantee that tail is mapped (and zero).
    need = (total_bits + 31) // 32 + 2
    if len(words) < need:
        words = np.concatenate([words, np.zeros(need - len(words), np.uint32)])
    vals = np.ascontiguousarray(code_values, np.uint32)
    lens = np.ascontiguousarray(code_lengths, np.uint8)
    lib = _build_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty(n, np.uint8)
    rc = lib.archon_bitunpack(_ptr(words), total_bits, _ptr(vals), _ptr(lens), _ptr(out), n)
    if rc != 0:
        raise ValueError("undecodable stream")
    return out


def mtf_rle0(L: np.ndarray) -> np.ndarray:
    """MTF + zero-run (RUNA/RUNB bijective base-2) transform -> u16 symbol
    stream over the 257-ary packed-container alphabet."""
    L = np.ascontiguousarray(L, np.uint8)
    lib = _build_lib()
    if lib is None:
        return _mtf_rle0_py(L)
    syms = np.empty(len(L) + 1, np.uint16)
    m = lib.archon_mtf_rle0(_ptr(L), len(L), _ptr(syms))
    return syms[:m]


def unrle0_unmtf(syms: np.ndarray, n: int) -> np.ndarray:
    syms = np.ascontiguousarray(syms, np.uint16)
    lib = _build_lib()
    if lib is None:
        return _unrle0_unmtf_py(syms, n)
    out = np.empty(n, np.uint8)
    rc = lib.archon_unrle0_unmtf(_ptr(syms), len(syms), _ptr(out), n)
    if rc != 0:
        raise ValueError("corrupt packed symbol stream")
    return out


def bitpack16(syms: np.ndarray, code_values, code_lengths):
    syms = np.ascontiguousarray(syms, np.uint16)
    vals = np.ascontiguousarray(code_values, np.uint32)
    lens = np.ascontiguousarray(code_lengths, np.uint8)
    lib = _build_lib()
    if lib is None:
        return _bitpack16_py(syms, vals, lens)
    words = np.zeros(len(syms) + 2, np.uint32)
    total = lib.archon_bitpack16(_ptr(syms), len(syms), _ptr(vals), _ptr(lens), _ptr(words))
    return words, int(total)


def bitunpack16(words: np.ndarray, total_bits: int, code_values, code_lengths, m: int):
    words = np.ascontiguousarray(words, np.uint32)
    need = (total_bits + 31) // 32 + 2  # wide loads may read past the end
    if len(words) < need:
        words = np.concatenate([words, np.zeros(need - len(words), np.uint32)])
    vals = np.ascontiguousarray(code_values, np.uint32)
    lens = np.ascontiguousarray(code_lengths, np.uint8)
    lib = _build_lib()
    if lib is None:
        return _bitunpack16_py(words, total_bits, vals, lens, m)
    out = np.empty(m, np.uint16)
    rc = lib.archon_bitunpack16(
        _ptr(words), total_bits, _ptr(vals), _ptr(lens), len(vals), _ptr(out), m
    )
    if rc != 0:
        raise ValueError("undecodable packed stream")
    return out


# --- pure-python fallbacks (toolchain-free environments; exact semantics) ---

def _mtf_rle0_py(L: np.ndarray) -> np.ndarray:
    mtf = list(range(256))
    out = []
    run = 0

    def emit(run):
        while run > 0:
            d = (run - 1) & 1
            out.append(d)
            run = (run - d - 1) >> 1

    for c in L.tolist():
        j = mtf.index(c)
        if j == 0:
            run += 1
            continue
        emit(run)
        run = 0
        mtf.pop(j)
        mtf.insert(0, c)
        out.append(j + 1)
    emit(run)
    return np.asarray(out, np.uint16)


def _unrle0_unmtf_py(syms: np.ndarray, n: int) -> np.ndarray:
    mtf = list(range(256))
    out = np.empty(n, np.uint8)
    w = 0
    run, scale = 0, 1
    for s in syms.tolist():
        if s <= 1:
            run += scale * (s + 1)
            scale <<= 1
            continue
        if run:
            if w + run > n:
                raise ValueError("corrupt packed symbol stream")
            out[w : w + run] = mtf[0]
            w += run
            run, scale = 0, 1
        c = mtf.pop(s - 1)
        mtf.insert(0, c)
        if w >= n:
            raise ValueError("corrupt packed symbol stream")
        out[w] = c
        w += 1
    if run:
        if w + run > n:
            raise ValueError("corrupt packed symbol stream")
        out[w : w + run] = mtf[0]
        w += run
    if w != n:
        raise ValueError("corrupt packed symbol stream")
    return out


def _bitpack16_py(syms, vals, lens):
    words = np.zeros(len(syms) + 2, np.uint32)
    k = 0
    for s in syms.tolist():
        c, l = int(vals[s]), int(lens[s])
        words[k >> 5] |= np.uint32((c << (k & 31)) & 0xFFFFFFFF)
        if (k & 31) + l > 32:
            words[(k >> 5) + 1] |= np.uint32(c >> (32 - (k & 31)))
        k += l
    return words, k


def _bitunpack16_py(words, total_bits, vals, lens, m):
    bits = np.unpackbits(
        words.view(np.uint8), bitorder="little"
    )[:total_bits]
    by_len: dict[int, dict[int, int]] = {}
    for s in range(len(vals)):
        if lens[s]:
            by_len.setdefault(int(lens[s]), {})[int(vals[s])] = s
    out = np.empty(m, np.uint16)
    pos = total_bits
    for j in range(m - 1, -1, -1):
        sym = -1
        acc = 0
        for l in range(1, 33):
            if pos - l < 0:
                break
            acc = (acc << 1) | int(bits[pos - l])
            got = by_len.get(l, {}).get(acc)
            if got is not None:
                sym = got
                pos -= l
                break
        if sym < 0:
            raise ValueError("undecodable packed stream")
        out[j] = sym
    return out


class MappedFile:
    """mmap-backed zero-copy file view (data-loader for block streaming)."""

    def __init__(self, path: str):
        lib = _build_lib()
        self._lib = lib
        self._handle = None
        if lib is None:
            self._data = np.fromfile(path, np.uint8)
            return
        size = ctypes.c_int64(0)
        h = lib.archon_map_open(str(path).encode(), ctypes.byref(size))
        if not h:
            raise OSError(f"cannot map {path}")
        self._handle = h
        ptr = lib.archon_map_data(h)
        self._data = (
            np.ctypeslib.as_array(ptr, shape=(size.value,))
            if size.value
            else np.zeros(0, np.uint8)
        )

    @property
    def data(self) -> np.ndarray:
        return self._data

    def blocks(self, block_size: int):
        n = len(self._data)
        for i in range(0, n, block_size):
            yield self._data[i : i + block_size]

    def close(self):
        if self._handle is not None:
            self._data = np.zeros(0, np.uint8)
            self._lib.archon_map_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
