"""Per-block entropy pack for the ATA2 container: MTF + RLE0 + Huffman.

The reference family's stated goal is compression "on par with ... bzip"
(the reference's README.md:17) but every generation emits the RAW BWT
symbols (a4/src/archon.c:227-234; a6/src/bwt.c:303-335) — the entropy back
end was always the missing piece.  This module is that back end, per
container block:

    L  --MTF-->  recency ranks  --RLE0-->  257-ary symbols  --Huffman--> bits

- MTF/RLE0 run natively (csrc/archon_host.cpp archon_mtf_rle0; the
  zero-run coding is Wheeler's bijective base-2 RUNA/RUNB, so a run of k
  zeros costs O(log k) symbols — the bzip2 scheme);
- the Huffman table is our exact a6-tie-break construction (entropy/huffman
  .huff_compute, generic over alphabet size) built from the block's OWN
  symbol histogram, which is stored sparsely in the payload and rebuilt at
  decode — the same rebuild-from-histogram trick core/a6 uses;
- the bit stream uses the a6 coder convention (LSB-first packing,
  backward-decodable; native first-bits table decode).

Payload layout (the bytes between the frame's u32 plen and u32 base):

    u8 method      0 = raw (incompressible block; payload = L itself)
                   1 = packed:
    u32 m          RLE0 symbol count
    u32 nbits      bit-stream length
    u16 npresent   distinct symbols
    npresent x (u16 symbol, u32 count)   sparse histogram, ascending
    ceil(nbits/32) x u32 words

The port's own copy of ``archon_tpu/entropy/pack.py``, on the port's
``native``.  ``stats`` counts what ``pack_block`` did, summed over the
threads that call it (``io/blocks._pack_payloads`` packs on a pool).
"""

from __future__ import annotations

import struct
import threading
import time

import numpy as np

from .. import native
from .huffman import huff_compute

NSYM = 257  # RUNA, RUNB, MTF values 1..255 shifted by +1


class _Counter:
    """Blocks packed, of them stored raw (method 0), their bytes in and
    payload bytes out (the method byte included), and the calls' own wall
    time in ns, since the last ``reset``.  ``add`` takes a lock: the pool's
    threads pack at the same time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.blocks = self.raw_blocks = self.bytes_in = self.bytes_out = self.ns = 0

    def add(self, n: int, payload: bytes, ns: int) -> None:
        with self._lock:
            self.blocks += 1
            self.raw_blocks += int(payload[0] == 0)
            self.bytes_in += n
            self.bytes_out += len(payload)
            self.ns += ns


stats = _Counter()


def _codes_for(present: np.ndarray, counts: np.ndarray):
    codes = huff_compute([int(c) for c in counts])
    vals = np.zeros(NSYM, np.uint32)
    lens = np.zeros(NSYM, np.uint8)
    maxlen = 0
    for sym, sc in zip(present.tolist(), codes):
        vals[sym] = sc.code
        lens[sym] = sc.length
        maxlen = max(maxlen, sc.length)
    return vals, lens, maxlen


def pack_block(L: np.ndarray) -> bytes:
    """Pack one block's BWT payload; falls back to raw storage whenever the
    packed form would not be smaller (or a pathological histogram drives
    Huffman past the 32-bit code limit).  Counted in ``stats``."""
    t = time.perf_counter_ns()
    L = np.ascontiguousarray(L, np.uint8)
    payload = _pack(L)
    stats.add(len(L), payload, time.perf_counter_ns() - t)
    return payload


def _pack(L: np.ndarray) -> bytes:
    n = len(L)
    if n == 0:
        return b"\x00"
    syms = native.mtf_rle0(L)
    m = len(syms)
    hist = np.bincount(syms, minlength=NSYM)
    present = np.nonzero(hist)[0]
    if len(present) == 1:
        # single-symbol stream: zero-length code, no bit stream at all
        head = struct.pack("<BIIH", 1, m, 0, 1) + struct.pack(
            "<HI", int(present[0]), int(hist[present[0]])
        )
        return head if len(head) < n + 1 else b"\x00" + L.tobytes()
    vals, lens, maxlen = _codes_for(present, hist[present])
    if maxlen > 32:
        return b"\x00" + L.tobytes()
    words, nbits = native.bitpack16(syms, vals, lens)
    nwords = (nbits + 31) // 32
    payload = (
        struct.pack("<BIIH", 1, m, nbits, len(present))
        + b"".join(
            struct.pack("<HI", int(s), int(hist[s])) for s in present.tolist()
        )
        + words[:nwords].tobytes()
    )
    if len(payload) >= n + 1:
        return b"\x00" + L.tobytes()
    return payload


def unpack_block(payload: bytes, n: int) -> np.ndarray:
    """Invert ``pack_block`` back to the n-byte BWT payload."""
    if n == 0:
        return np.zeros(0, np.uint8)
    method = payload[0]
    if method == 0:
        out = np.frombuffer(payload[1:], np.uint8)
        if len(out) != n:
            raise ValueError("raw payload length mismatch")
        return out
    if method != 1:
        raise ValueError(f"unknown pack method {method}")
    m, nbits, npresent = struct.unpack("<IIH", payload[1:11])
    pos = 11
    present = np.empty(npresent, np.int64)
    counts = np.empty(npresent, np.int64)
    for i in range(npresent):
        s, c = struct.unpack("<HI", payload[pos : pos + 6])
        present[i], counts[i] = s, c
        pos += 6
    if npresent == 1:
        syms = np.full(m, present[0], np.uint16)
    else:
        vals, lens, maxlen = _codes_for(present, counts)
        if maxlen > 32:
            raise ValueError("corrupt histogram: code overflow")
        words = np.frombuffer(payload[pos:], np.uint32)
        syms = native.bitunpack16(words, nbits, vals, lens, m)
    return native.unrle0_unmtf(syms, n)
