"""The ATM1 sharded megablock container, read and written by plain code.

Layout (the port's ``parallel/megapipe.py`` docstring)::

    header: b'ATM1' | u8 generation (0=a4, 1=a7) | u8 coder (1=var) | u16 n_shards
            | u64 n | u32 base | u32 pad
    table : 256 x u32 histogram of L (the decoder rebuilds the Huffman code from it)
    shard : u32 nbits | ceil(nbits / 8) bytes      (x n_shards; shard s codes L[s*S:(s+1)*S])

Each symbol's code is written at increasing bit offsets, the code's bit 0
first, and bit b of a shard's stream is bit b % 8 of byte b // 8.  The input
is padded to a multiple of the shard count with the format's filler.

``build`` writes the container of the reference BWT of the whole input as
one block.  Comparing its bytes with the program's compares the header, the
base, the table and every coded symbol: a prefix code of the same table
gives equal bits exactly where it codes equal symbols, so this is the check
that decoding the program's bits back to L would make.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .bwt import frame_bwt
from .huffman import build_encoder_var

MAGIC = b"ATM1"
GENERATION_IDS = {"a4": 0, "a7": 1}
CODER_IDS = {"var": 1}
HEADER = struct.Struct("<4sBBHQII")
TABLE_BYTES = 256 * 4


def padded(data: bytes, shards: int) -> tuple[np.ndarray, int]:
    """The input padded to a multiple of ``shards`` with the format's
    non-repetitive filler, and the pad length."""
    arr = np.frombuffer(bytes(data), np.uint8)
    pad = (-len(arr)) % shards
    if pad:
        filler = ((np.arange(pad, dtype=np.uint64) * 2654435761) >> 20).astype(np.uint8)
        arr = np.concatenate([arr, filler])
    return arr, pad


def pack_bits(sym: torch.Tensor, values: torch.Tensor, lengths: torch.Tensor) -> tuple[int, bytes]:
    """(nbits, stream bytes) of the uint8 symbols ``sym`` under the code
    (``values``, ``lengths``: int64 tensors of 256 on ``sym``'s device)."""
    idx = sym.to(torch.int64)
    lens = lengths[idx]
    codes = values[idx]
    ends = torch.cumsum(lens, 0)
    nbits = int(ends[-1]) if sym.numel() else 0
    starts = ends - lens
    bits = torch.zeros(-(-nbits // 8) * 8, dtype=torch.uint8, device=sym.device)
    for j in range(int(lengths.max()) if nbits else 0):
        m = lens > j
        bits[starts[m] + j] = ((codes[m] >> j) & 1).to(torch.uint8)
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.int32, device=sym.device)
    stream = (bits.view(-1, 8).to(torch.int32) * weights).sum(1).to(torch.uint8)
    return nbits, stream.cpu().numpy().tobytes()


def build(data: bytes, generation: str, shards: int, coder: str, device,
          depth: int | None = None) -> bytes:
    """The container of ``data`` sorted as one block by ``frame_bwt``."""
    if coder not in CODER_IDS:
        raise ValueError(f"the reference writes only the var coder, not {coder!r}")
    arr, pad = padded(data, shards)
    n = len(arr)
    L_np, base = frame_bwt(arr, generation, device, depth)
    L = torch.from_numpy(L_np).to(device)
    hist = torch.bincount(L.to(torch.int64), minlength=256).cpu().numpy()
    codes = build_encoder_var(hist)
    values = torch.tensor([c.code for c in codes], dtype=torch.int64, device=device)
    lengths = torch.tensor([c.length for c in codes], dtype=torch.int64, device=device)
    out = [HEADER.pack(MAGIC, GENERATION_IDS[generation], CODER_IDS[coder], shards, n, base, pad),
           hist.astype("<u4").tobytes()]
    S = n // shards
    for s in range(shards):
        nbits, stream = pack_bits(L[s * S : (s + 1) * S], values, lengths)
        out += [struct.pack("<I", nbits), stream]
    return b"".join(out)


def parse(blob: bytes) -> tuple[tuple, bytes, list[bytes]]:
    """(header fields, table bytes, [u32 nbits + stream of each shard]);
    raises ValueError on a blob that does not parse."""
    if len(blob) < HEADER.size + TABLE_BYTES:
        raise ValueError("short header")
    header = HEADER.unpack_from(blob, 0)
    table = blob[HEADER.size : HEADER.size + TABLE_BYTES]
    pos, shards = HEADER.size + TABLE_BYTES, []
    for _ in range(header[3]):
        if pos + 4 > len(blob):
            raise ValueError("truncated shard")
        (nbits,) = struct.unpack_from("<I", blob, pos)
        end = pos + 4 + -(-nbits // 8)
        if end > len(blob):
            raise ValueError("truncated shard")
        shards.append(blob[pos:end])
        pos = end
    if pos != len(blob):
        raise ValueError("trailing bytes")
    return header, table, shards


def summary(blob: bytes) -> tuple:
    """The header, the table and each shard's bit count, read without
    copying the streams: what the run keeps of every container of its
    window."""
    try:
        header = HEADER.unpack_from(blob, 0)
        pos, nbits = HEADER.size + TABLE_BYTES, []
        for _ in range(header[3]):
            nbits.append(struct.unpack_from("<I", blob, pos)[0])
            pos += 4 + -(-nbits[-1] // 8)
    except struct.error:
        return ("unparsable", len(blob))
    return header, blob[HEADER.size : HEADER.size + TABLE_BYTES], tuple(nbits), pos == len(blob)


def diff(got: bytes, want: bytes) -> dict[str, int]:
    """Counts of what differs between a blob and the reference's: the header
    (all fields but the base), the base, the table, and each shard's bits."""
    counts = {"header": 0, "base": 0, "table": 0, "shard_bits": 0}
    if got == want:
        return counts
    want_header, want_table, want_shards = parse(want)
    try:
        got_header, got_table, got_shards = parse(got)
    except ValueError:
        return {"header": 1, "base": 1, "table": 1, "shard_bits": len(want_shards)}
    counts["header"] = int(got_header[:5] + got_header[6:] != want_header[:5] + want_header[6:])
    counts["base"] = int(got_header[5] != want_header[5])
    counts["table"] = int(got_table != want_table)
    counts["shard_bits"] = sum(
        i >= len(got_shards) or i >= len(want_shards) or got_shards[i] != want_shards[i]
        for i in range(max(len(got_shards), len(want_shards))))
    return counts
