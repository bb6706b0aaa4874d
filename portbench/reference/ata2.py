"""The ATA2 block container, read and written by plain code.

Layout (the port's ``io/blocks.py`` and ``entropy/pack.py`` docstrings)::

    header : b'ATA2' | u8 generation (0=a4, 1=a7) | u8 flags (1) | u16 0 | u32 block_size
    frame  : u32 n | u32 plen | plen bytes of payload | u32 base     (one per block, in order)
    payload: u8 method 0 | n bytes of L                               (raw)
             u8 method 1 | u32 m | u32 nbits | u16 npresent
             | npresent x (u16 symbol, u32 count) | ceil(nbits/32) x u32 words

A packed payload is L through move-to-front, then RLE0 (a run of k zero
ranks as the bijective base-2 digits of k, least significant first:
0 = RUNA for the digit 1, 1 = RUNB for the digit 2; a rank v >= 1 as v + 1),
then a Huffman code built by ``huffman.huff_compute`` over the symbols
present, in ascending order, from their counts.  Each code's bits go
LSB-first at increasing offsets into little-endian u32 words.  The payload
is raw for an empty block, where a code would exceed 32 bits, and where the
packed form is not smaller than n + 1 bytes; a stream of one symbol takes
the zero-length code and no words.

Written from that format, not from the program: move-to-front is computed
without a loop over the bytes (``mtf_ranks``), so that it runs on the card.
``build`` writes the container whose frames come from ``bwt.frame_bwt``;
``diff`` counts, part by part, where a blob differs from it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .ata1 import GENERATION_IDS, blocks_of
from .bwt import frame_bwt
from .huffman import huff_compute

MAGIC = b"ATA2"
FLAGS = 1
HEADER = struct.Struct("<4sBBHI")
PACKED_HEAD = struct.Struct("<BIIH")  # method, m, nbits, npresent
ENTRY = struct.Struct("<HI")  # symbol, count
SYMBOL_CHUNK = 16  # symbols whose running counts are held at once


def mtf_ranks(L: torch.Tensor) -> torch.Tensor:
    """Move-to-front ranks (int64) of the uint8 tensor ``L``, the list
    starting as 0, 1, ..., 255.  Symbol d is given the virtual position
    -(d + 1) before the block, so every symbol has a last position before
    each i; the rank of ``L[i]`` is the number of distinct symbols at the
    positions strictly between ``L[i]``'s last position and i."""
    n = L.numel()
    dev = L.device
    x = torch.cat([torch.arange(255, -1, -1, device=dev), L.to(torch.int64)])  # virtual prefix
    # prev[i]: the last position in x before 256 + i that holds the same symbol
    order = torch.sort(x, stable=True).indices
    same = torch.zeros(n + 256, dtype=torch.bool, device=dev)
    same[1:] = x[order[1:]] == x[order[:-1]]
    prev_of = torch.full((n + 256,), -1, dtype=torch.int64, device=dev)
    prev_of[order[1:][same[1:]]] = order[:-1][same[1:]]
    prev = prev_of[256:]
    ranks = torch.zeros(n, dtype=torch.int64, device=dev)
    for d0 in range(0, 256, SYMBOL_CHUNK):
        syms = torch.arange(d0, d0 + SYMBOL_CHUNK, device=dev)[:, None]
        # seen[d, k]: occurrences of symbol d in x[:k]
        seen = torch.zeros(SYMBOL_CHUNK, n + 257, dtype=torch.int32, device=dev)
        seen[:, 1:] = torch.cumsum((x[None, :] == syms).to(torch.int32), 1, dtype=torch.int32)
        between = seen[:, 256:-1] - seen[:, prev + 1]  # occurrences in x[prev + 1 : 256 + i]
        ranks += (between > 0).sum(0)
    return ranks


def rle0(ranks: torch.Tensor) -> torch.Tensor:
    """The 257-symbol stream (int64) of move-to-front ranks: each maximal
    run of k zeros as the bits of k + 1 below its top bit, least
    significant first (0 = RUNA, 1 = RUNB), each rank v >= 1 as v + 1."""
    n = ranks.numel()
    dev = ranks.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    zero = ranks == 0
    run_start = zero.clone()
    run_start[1:] &= ~zero[:-1]
    tok = torch.nonzero(~zero | run_start).flatten()  # one token a nonzero rank or a run
    ends = torch.cat([tok[1:], torch.tensor([n], device=dev)])
    is_run = zero[tok]
    top = ends - tok + 1  # k + 1 of a run
    bits = torch.zeros_like(top)  # bits of k + 1 below its top bit
    for b in range(1, int(top.max()).bit_length()):
        bits += (top >> b) > 0
    width = torch.where(is_run, bits, torch.ones_like(bits))
    start = torch.cumsum(width, 0) - width
    owner = torch.repeat_interleave(torch.arange(tok.numel(), device=dev), width)
    digit = torch.arange(owner.numel(), device=dev) - start[owner]
    return torch.where(is_run[owner], (top[owner] >> digit) & 1, ranks[tok][owner] + 1)


def bitpack(syms: torch.Tensor, codes: torch.Tensor, lengths: torch.Tensor) -> tuple[np.ndarray, int]:
    """(u32 words, bit count) of ``syms`` coded by ``codes``/``lengths``
    (indexed by symbol), each code's bits LSB-first from the running bit
    offset.  Codes do not overlap, so a word is the sum of its pieces."""
    lens = lengths[syms]
    at = torch.cumsum(lens, 0) - lens
    nbits = int(lens.sum())
    placed = codes[syms] << (at & 31)  # up to 63 bits: this word's part and the next's
    words = torch.zeros((nbits + 31) // 32 + 1, dtype=torch.int64, device=syms.device)
    words.index_add_(0, at >> 5, placed & 0xFFFFFFFF)
    words.index_add_(0, (at >> 5) + 1, placed >> 32)
    return words[: (nbits + 31) // 32].cpu().numpy().astype("<u4"), nbits


def payload(L: np.ndarray, device="cpu") -> bytes:
    """The payload of one frame's L (uint8 numpy)."""
    n = len(L)
    raw = b"\x00" + L.tobytes()
    if n == 0:
        return raw
    syms = rle0(mtf_ranks(torch.from_numpy(np.array(L, np.uint8)).to(device)))
    hist = torch.bincount(syms, minlength=257).cpu().numpy()
    present = np.nonzero(hist)[0].tolist()
    head = PACKED_HEAD.pack(1, syms.numel(), 0, len(present))
    table = b"".join(ENTRY.pack(s, int(hist[s])) for s in present)
    if len(present) == 1:
        out = head + table
        return out if len(out) < n + 1 else raw
    sc = huff_compute([int(hist[s]) for s in present])
    if max(c.length for c in sc) > 32:
        return raw
    codes = torch.zeros(257, dtype=torch.int64)
    lengths = torch.zeros(257, dtype=torch.int64)
    codes[present] = torch.tensor([c.code for c in sc])
    lengths[present] = torch.tensor([c.length for c in sc])
    words, nbits = bitpack(syms, codes.to(syms.device), lengths.to(syms.device))
    out = PACKED_HEAD.pack(1, syms.numel(), nbits, len(present)) + table + words.tobytes()
    return out if len(out) < n + 1 else raw


def build(data: bytes, generation: str, block_size: int, device, depth: int | None = None) -> bytes:
    """The container of ``data`` with every frame's L from ``frame_bwt``
    (``depth`` as there) and its payload from ``payload``."""
    out = [HEADER.pack(MAGIC, GENERATION_IDS[generation], FLAGS, 0, block_size)]
    for blk in blocks_of(data, block_size):
        L, base = frame_bwt(blk, generation, device, depth)
        p = payload(L, device)
        out += [struct.pack("<II", len(blk), len(p)), p, struct.pack("<I", base)]
    return b"".join(out)


def parse(blob: bytes) -> tuple[tuple, list[tuple[int, bytes, int]]]:
    """(header fields, [(n, payload, base), ...]); raises ValueError on a
    blob that does not parse."""
    if len(blob) < HEADER.size:
        raise ValueError("short header")
    header = HEADER.unpack_from(blob, 0)
    frames, pos = [], HEADER.size
    while pos < len(blob):
        if pos + 8 > len(blob):
            raise ValueError("truncated frame head")
        n, plen = struct.unpack_from("<II", blob, pos)
        if pos + 12 + plen > len(blob):
            raise ValueError("truncated frame")
        (base,) = struct.unpack_from("<I", blob, pos + 8 + plen)
        frames.append((n, blob[pos + 8 : pos + 8 + plen], base))
        pos += 12 + plen
    return header, frames


def summary(blob: bytes) -> tuple:
    """The header and each frame's (n, plen, base), read without copying a
    payload: what the run keeps of every container of its window."""
    try:
        header, pos, frames = HEADER.unpack_from(blob, 0), HEADER.size, []
        while pos < len(blob):
            n, plen = struct.unpack_from("<II", blob, pos)
            (base,) = struct.unpack_from("<I", blob, pos + 8 + plen)
            frames.append((n, plen, base))
            pos += 12 + plen
    except struct.error:
        return ("unparsable", len(blob))
    return header, tuple(frames)


def diff(got: bytes, want: bytes) -> dict[str, int]:
    """Counts of what differs between a blob and the reference's: the
    header, and each frame's n, payload and base (a frame missing or extra
    counts under every part)."""
    counts = {"header": 0, "frame_n": 0, "frame_payload": 0, "frame_base": 0}
    if got == want:
        return counts
    want_header, want_frames = parse(want)
    try:
        got_header, got_frames = parse(got)
    except ValueError:
        return {k: max(1, len(want_frames)) for k in counts}
    counts["header"] = int(got_header != want_header)
    for i in range(max(len(got_frames), len(want_frames))):
        if i >= len(got_frames) or i >= len(want_frames):
            for k in ("frame_n", "frame_payload", "frame_base"):
                counts[k] += 1
            continue
        (gn, gp, gb), (wn, wp, wb) = got_frames[i], want_frames[i]
        counts["frame_n"] += gn != wn
        counts["frame_payload"] += gp != wp
        counts["frame_base"] += gb != wb
    return counts
