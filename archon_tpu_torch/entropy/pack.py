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
``native``, and beside it the same payloads packed on the device where a
batch of L rows lies (``RowPack``, over the kernels of ``ops.pack``).  Both
take the payload's head and the raw decision from ``_plan``.  ``stats``
counts what ``pack_block`` and ``RowPack`` did, summed over the threads that
call them (``io/blocks._pack_payloads`` packs on a pool).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..ops import pack as ops_pack
from ..utils.timing import span
from .huffman import huff_compute

NSYM = 257  # RUNA, RUNB, MTF values 1..255 shifted by +1


class _Counter:
    """Blocks packed, of them stored raw (method 0) and packed on the device
    (``device_blocks``), their bytes in and payload bytes out (the method
    byte included), and the host wall time of the calls in ns, since the
    last ``reset``.  The adds take a lock: the pool's threads pack at the
    same time."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.blocks = self.raw_blocks = self.device_blocks = 0
            self.bytes_in = self.bytes_out = self.ns = 0

    def add(self, n: int, payload: bytes, ns: int) -> None:
        self.add_rows(n, [payload], ns)

    def add_rows(self, n: int, payloads: list, ns: int, device: bool = False) -> None:
        """Rows of n bytes each, their payloads, and the calls' wall time."""
        with self._lock:
            self.blocks += len(payloads)
            self.raw_blocks += sum(p[0] == 0 for p in payloads)
            self.device_blocks += len(payloads) if device else 0
            self.bytes_in += n * len(payloads)
            self.bytes_out += sum(map(len, payloads))
            self.ns += ns


stats = _Counter()


def _codes_for(present: np.ndarray, counts: np.ndarray):
    """The code values and lengths of the ``present`` symbols, and the
    longest length; past 32 bits (a code u32 words cannot hold) the tables
    are left empty, since no caller uses them then."""
    codes = huff_compute([int(c) for c in counts])
    vals = np.zeros(NSYM, np.uint32)
    lens = np.zeros(NSYM, np.uint8)
    maxlen = max(sc.length for sc in codes)
    if maxlen > 32:
        return vals, lens, maxlen
    for sym, sc in zip(present.tolist(), codes):
        vals[sym] = sc.code
        lens[sym] = sc.length
    return vals, lens, maxlen


class Plan(NamedTuple):
    """A packed payload but its words: the head (method, m, nbits, the
    sparse histogram), the code table (None for a single-symbol stream,
    which has no bit stream) and the count of u32 words that follow."""

    head: bytes
    codes: tuple | None
    nwords: int


def _plan(n: int, m: int, hist: np.ndarray) -> Plan | None:
    """How a block of n > 0 bytes whose MTF/RLE0 stream has m symbols with
    histogram ``hist`` is stored: its ``Plan``, or None where it is stored
    raw, because the packed form would not be smaller than the n + 1 bytes
    of the raw one, or a pathological histogram drives Huffman past the
    32-bit code limit."""
    hist = np.asarray(hist, np.int64)
    present = np.nonzero(hist)[0]
    if len(present) == 1:
        # single-symbol stream: zero-length code, no bit stream at all
        head = struct.pack("<BIIH", 1, m, 0, 1) + struct.pack(
            "<HI", int(present[0]), int(hist[present[0]])
        )
        return Plan(head, None, 0) if len(head) < n + 1 else None
    vals, lens, maxlen = _codes_for(present, hist[present])
    if maxlen > 32:
        return None
    nbits = int(hist @ lens.astype(np.int64))
    nwords = (nbits + 31) // 32
    head = struct.pack("<BIIH", 1, m, nbits, len(present)) + b"".join(
        struct.pack("<HI", int(s), int(hist[s])) for s in present.tolist()
    )
    if len(head) + 4 * nwords >= n + 1:
        return None
    return Plan(head, (vals, lens), nwords)


def pack_block(L: np.ndarray) -> bytes:
    """Pack one block's BWT payload on the host; stored raw where ``_plan``
    says so.  Counted in ``stats``."""
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
    plan = _plan(n, len(syms), np.bincount(syms, minlength=NSYM))
    if plan is None:
        return b"\x00" + L.tobytes()
    if plan.codes is None:
        return plan.head
    words, _nbits = native.bitpack16(syms, *plan.codes)
    return plan.head + words[: plan.nwords].tobytes()


def _to_host(t: torch.Tensor):
    """A host copy of ``t`` on its way and the event that says it is there:
    from a CUDA tensor a non-blocking copy into pinned memory, queued on the
    current stream; a CPU tensor is its own copy (no event)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    return host, done


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` on ``dev``: to a CUDA device through pinned memory, without
    waiting for the work queued there."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def _wait(done) -> None:
    if done is not None:
        done.synchronize()


class RowPack:
    """The payloads of a (B, n) batch of L rows, packed on the device where
    the rows lie (``ops.pack``; a CPU tensor takes the kernels' plain twins),
    byte for byte ``pack_block``'s.  Three calls, each on the host thread
    that drives the device:

    - made right after the rows are computed, it enqueues MTF, the zero runs
      and the histograms, and the histograms' copy back
      (``archon.pack.launch``);
    - ``plan()`` takes the histograms and symbol counts, builds each row's
      codes and decides its form with ``_plan`` (``archon.pack.codes``), then
      enqueues the words of the rows it packs and their copy back
      (``archon.pack.words``).  Called once the next batch is enqueued, it
      waits only for this batch's histograms, and the Huffman builds run
      while the device works on the next batch;
    - ``payloads(rows)`` waits for the words and joins the payloads of
      ``rows``, copying back L for those it stores raw
      (``archon.pack.words``).

    Counted in ``stats`` by ``payloads``: each row as a device block, the
    host time of the three calls as ``ns``."""

    def __init__(self, L: torch.Tensor):
        t = time.perf_counter_ns()
        with span("archon.pack.launch"):
            self._L = L.contiguous()
            self._state = ops_pack.mtf_rle(self._L)
            self._head = _to_host(self._state.head)
        self._plans = None
        self._ns = time.perf_counter_ns() - t

    def plan(self) -> None:
        if self._plans is not None:
            return
        t = time.perf_counter_ns()
        B, n = self._L.shape
        with span("archon.pack.codes"):
            head, done = self._head
            _wait(done)
            head = head.numpy()
            self._plans = [_plan(n, int(head[r, NSYM]), head[r, :NSYM]) for r in range(B)]
        with span("archon.pack.words"):
            tables = np.zeros((2, B, NSYM), np.uint32)  # each row's code values, lengths
            self._row_word = np.full(B, -1, np.int64)
            total = 0
            for r, plan in enumerate(self._plans):
                if plan is not None and plan.codes is not None:
                    tables[:, r] = plan.codes
                    self._row_word[r] = total
                    total += plan.nwords
            self._words = (None, None)
            if total:
                tables, row_word = (_to_device(a, self._L.device)
                                    for a in (tables.view(np.int32), self._row_word))
                self._words = _to_host(ops_pack.pack_words(self._state, tables[0], tables[1],
                                                           row_word, total))
        self._ns += time.perf_counter_ns() - t

    def payloads(self, rows: list) -> list[bytes]:
        self.plan()
        t = time.perf_counter_ns()
        with span("archon.pack.words"):
            words, done = self._words
            _wait(done)
            if words is not None:
                words = words.numpy().view(np.uint32)
            plans = [self._plans[r] for r in rows]
            raw = [r for r, plan in zip(rows, plans) if plan is None]
            L_raw = dict(zip(raw, self._L[raw].cpu().numpy())) if raw else {}
            out = []
            for r, plan in zip(rows, plans):
                if plan is None:
                    out.append(b"\x00" + L_raw[r].tobytes())
                elif plan.codes is None:
                    out.append(plan.head)
                else:
                    w0 = self._row_word[r]
                    out.append(b"".join((plan.head, words[w0 : w0 + plan.nwords])))
        stats.add_rows(self._L.shape[1], out, self._ns + time.perf_counter_ns() - t, device=True)
        return out


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
