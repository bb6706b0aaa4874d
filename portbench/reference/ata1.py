"""The ATA1 block container, read and written by plain code.

Layout (the port's ``io/blocks.py`` docstring, and the Archon x1 framing)::

    header: b'ATA1' | u8 generation (0=a4, 1=a7) | u8 flags (0) | u16 0 | u32 block_size
    frame : u32 n | n bytes of L | u32 base           (one per block, in order)

``build`` writes the container that the reference BWT gives; ``diff`` counts,
part by part, where a blob differs from it.
"""

from __future__ import annotations

import struct

from .bwt import frame_bwt

MAGIC = b"ATA1"
GENERATION_IDS = {"a4": 0, "a7": 1}
HEADER = struct.Struct("<4sBBHI")


def blocks_of(data: bytes, block_size: int) -> list[bytes]:
    return [data[i : i + block_size] for i in range(0, len(data), block_size)] or [b""]


def build(data: bytes, generation: str, block_size: int, device, depth: int | None = None) -> bytes:
    """The container of ``data`` with every frame from ``frame_bwt``."""
    out = [HEADER.pack(MAGIC, GENERATION_IDS[generation], 0, 0, block_size)]
    for blk in blocks_of(data, block_size):
        L, base = frame_bwt(blk, generation, device, depth)
        out += [struct.pack("<I", len(blk)), L.tobytes(), struct.pack("<I", base)]
    return b"".join(out)


def parse(blob: bytes) -> tuple[tuple, list[tuple[int, bytes, int]]]:
    """(header fields, [(n, L, base), ...]); raises ValueError on a blob that
    does not parse."""
    if len(blob) < HEADER.size:
        raise ValueError("short header")
    header = HEADER.unpack_from(blob, 0)
    frames, pos = [], HEADER.size
    while pos < len(blob):
        if pos + 4 > len(blob):
            raise ValueError("truncated frame length")
        (n,) = struct.unpack_from("<I", blob, pos)
        if pos + 8 + n > len(blob):
            raise ValueError("truncated frame")
        L = blob[pos + 4 : pos + 4 + n]
        (base,) = struct.unpack_from("<I", blob, pos + 4 + n)
        frames.append((n, L, base))
        pos += 8 + n
    return header, frames


def summary(blob: bytes) -> tuple:
    """The header and each frame's (n, base), read without copying L: what
    the run keeps of every container of its window."""
    try:
        header, pos, frames = HEADER.unpack_from(blob, 0), HEADER.size, []
        while pos < len(blob):
            (n,) = struct.unpack_from("<I", blob, pos)
            (base,) = struct.unpack_from("<I", blob, pos + 4 + n)
            frames.append((n, base))
            pos += 8 + n
    except struct.error:
        return ("unparsable", len(blob))
    return header, tuple(frames)


def diff(got: bytes, want: bytes) -> dict[str, int]:
    """Counts of what differs between a blob and the reference's: the
    header, and each frame's n, L and base (a frame missing or extra counts
    under every part)."""
    counts = {"header": 0, "frame_n": 0, "frame_L": 0, "frame_base": 0}
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
            for k in ("frame_n", "frame_L", "frame_base"):
                counts[k] += 1
            continue
        (gn, gL, gb), (wn, wL, wb) = got_frames[i], want_frames[i]
        counts["frame_n"] += gn != wn
        counts["frame_L"] += gL != wL
        counts["frame_base"] += gb != wb
    return counts
