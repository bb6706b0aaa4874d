"""Golden (oracle) emulator of the a6 generation — the full compressor.

Pipeline semantics (a6/src/bwt.c:349-439 ``bwt_transform``, :303-335
``bwt_write``), validated against the compiled reference binary:

1. Histogram the input; build an encoder table per config:
   'byte' (identity 8-bit), 'fix' (rank codes of ceil(log2(nd)) bits),
   'var' (exact-replica Huffman, entropy/huffman.py).
2. Bit-pack the input symbol-by-symbol (codes LSB-first at increasing
   offsets, coder.c:108-123).
3. Suffix-sort the N codeword *end offsets* of the bit stream by backward
   bit reading (get_key_fixed reads the 32 bits before an offset MSB-last,
   bwt.c:112-117; sort_bese descends in 32-bit chunks, bwt.c:165-183).
   Reading off the left edge hits ``termin`` = 10 bytes of 0xFF
   (bwt.c:37,362): ties resolve as if the stream were preceded by ~80 one
   bits; beyond that the reference reads heap garbage (undefined) — this
   model extends the ones indefinitely.
4. Output: u32-LE base_id FIRST (bwt.c:310; unlike a4/a7), then for each
   sorted offset the *following* symbol's byte (move_right + get_char,
   bwt.c:312-330), the full-stream offset wrapping to the first symbol.

The alphabet reorder option (-o) is parsed but never applied in the
committed reference (main.c:55-96 fills f_order; nothing calls it), so it
does not affect output; the heuristics are still ported in
``entropy/order.py`` for component parity.

The inverse (-u, bwt.c:446-478) is an a7-convention byte-level LF walk:
symbol-level LF consistency holds because prefix-free codes re-align after
the first symbol.

The port's own copy of ``archon_tpu/golden/a6.py``.
"""

from __future__ import annotations

import numpy as np

from ..entropy import coder as coder_mod
from ..entropy.huffman import (
    build_encoder_byte,
    build_encoder_fixed,
    build_encoder_var,
)
from .sa import SENT_LARGE, bwt_inverse, suffix_array

TERMIN_BITS = 80  # 10 bytes of 0xFF before the stream (a6/src/bwt.c:37)


def _build_codes(data: np.ndarray, config: str):
    freq = np.bincount(data, minlength=256)
    if config == "byte":
        return build_encoder_byte()
    if config == "fix":
        return build_encoder_fixed(freq)[0]
    if config == "var":
        return build_encoder_var(freq)
    raise ValueError(f"bad a6 config {config!r}")


def a6_encode(data: bytes, config: str = "byte") -> bytes:
    """Byte-exact emulator of ``archon6 <in> <out> -c <config>``."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr)
    if n == 0:
        return np.uint32(0).tobytes()
    codes = _build_codes(arr, config)
    stream, ends, total_bits = coder_mod.encode_stream(arr, codes)
    if total_bits == 0:
        raise ValueError("degenerate zero-length codes (single-symbol input)")

    bits = coder_mod.bits_of_stream(stream, total_bits)
    # Backward reading from offset k == forward reading of the reversed bit
    # string from position total_bits - k; the left-edge 0xFF termin becomes
    # a suffix of ones appended to the reversed string.
    rev = bits[::-1]
    padded = np.concatenate([rev, np.ones(TERMIN_BITS, np.uint8)])
    sa = suffix_array(padded, SENT_LARGE)
    rank = np.empty(len(padded), np.int64)
    rank[sa] = np.arange(len(padded))

    sel = total_bits - ends  # reversed-string positions of codeword ends
    order = np.argsort(rank[sel], kind="stable")  # sorted symbol indices j
    # base: the full-stream offset (ends[n-1] == total_bits, sel == 0)
    base = int(np.nonzero(sel[order] == 0)[0][0])
    # emit the symbol *after* j (wrapping to symbol 0 for the full offset)
    out = arr[(order + 1) % n]
    return np.uint32(base).tobytes() + out.tobytes()


def a6_decode(blob: bytes, config: str = "byte") -> bytes:
    """Invert an a6 blob.

    config 'byte'/'fix': byte-exact emulator of ``archon6 -u``
    (a6/src/bwt.c:446-478: base-last LF roll + chain walk) — for these
    configs code order equals byte order, so the byte-level walk is exact.

    config 'var': the reference ``-u`` is broken here (verified): it builds
    LF buckets in ascending *byte* order while the var transform sorted
    suffixes in ascending *code* order.  Since the payload is a permutation
    of the original text, its histogram reproduces the original frequencies;
    we rebuild the exact Huffman table from it and walk with code-ordered
    buckets — a correct inverse the reference lacks.
    """
    base = int(np.frombuffer(blob[:4], dtype=np.uint32)[0])
    L = np.frombuffer(blob[4:], dtype=np.uint8)
    n = len(L)
    if n == 0:
        return b""
    if config in ("byte", "fix"):
        return bwt_inverse(L, base, SENT_LARGE).tobytes()
    if config != "var":
        raise ValueError(f"bad a6 config {config!r}")

    codes = build_encoder_var(np.bincount(L, minlength=256))
    # bucket order = ascending MSB-aligned code value (prefix-free, distinct)
    keys = np.array(
        [
            (codes[c].code << (32 - codes[c].length)) if codes[c].length else -1
            for c in range(256)
        ],
        np.int64,
    )
    sym_order = np.argsort(keys, kind="stable")  # absent symbols (-1) first, freq 0
    counts = np.bincount(L, minlength=256)
    starts = np.zeros(256, np.int64)
    acc = 0
    for c in sym_order:
        starts[c] = acc
        acc += counts[c]

    # LF successor with code-ordered bucket starts; base rolls last
    order = np.concatenate(
        (np.arange(0, base), np.arange(base + 1, n), [base])
    )
    P = np.empty(n, np.int64)
    ctr = starts.copy()
    for i in order:
        P[i] = ctr[L[i]]
        ctr[L[i]] += 1
    out = np.empty(n, np.uint8)
    k = base
    for i in range(n):
        out[i] = L[k]
        k = P[k]
    return out.tobytes()
