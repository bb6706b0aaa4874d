"""Block-streamed container, ATA1/ATA2 (port of the stream path of
``archon_tpu/io/blocks.py``).

The framing is the JAX package's own, imported from it through ``host``
(its module imports only os, struct and numpy):

    header: magic b'ATA1' | u8 generation (0=a4, 1=a7) | u8 flags
            | u16 reserved | u32 block_size
    block : u32 n | n payload bytes | u32 base                    (ATA1)
            u32 n | u32 plen | packed payload | u32 base          (ATA2)

Each block is reversed, transformed by ``core.fast2.bwt_v3`` on the device,
and its (L, base) written as one frame; ``pack=True`` entropy-packs each L
on the host (``archon_tpu.entropy.pack``).  Decode is the native LF walk.
"""

from __future__ import annotations

import os
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.doubling import SENT_LARGE, SENT_SMALL
from ..host import (
    DEFAULT_BLOCK,
    FLAG_PACKED,
    GENERATIONS,
    MAGIC,
    MAGIC_PACKED,
    PIPE_BLOCKS,
    _pack_payloads,
    golden,
    native,
    unpack_block,
)

__all__ = ["encode_file", "decode_file", "as_device", "host_walk", "DEFAULT_BLOCK"]


def as_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a usable card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is false")
    return dev


def host_walk() -> str:
    """The host LF walk that verify and decode use: ``"native"`` (the C++
    library, built on first call) or ``"golden"`` (the numpy model, taken
    when no C++ toolchain is found, and orders of magnitude slower)."""
    return "native" if native.available() else "golden"


def _inverse(L: np.ndarray, base: int, sentinel: str, use_native: bool) -> np.ndarray:
    """Host LF walk: the native one, or the golden model without a toolchain.

    Callers decide ``use_native = native.available()`` on their own thread
    before any pool starts: ``native`` builds its library on first call and
    concurrent first callers would see no library and take the slow path."""
    if use_native:
        return native.unbwt(L, base, sentinel == SENT_LARGE)
    return golden.bwt_inverse(L, base, sentinel)


def _streamed_forward(blocks: list[bytes], generation: str, verify: bool, device) -> list:
    """Per-block forward BWT stream: each block runs ``bwt_v3`` on
    ``device``; at most ``PIPE_BLOCKS`` results stay on the device before the
    oldest is copied back, bounding device memory to O(window * block).

    ``verify=True`` round-trips every block through the host LF walk
    (``native.unbwt(L, base) == block``) on a thread pool, each block as soon
    as its L is on the host, so the walks overlap the device work of the
    blocks after it."""
    from ..core.fast2 import bwt_v3

    dev = as_device(device)
    sentinel = SENT_SMALL if generation == "a4" else SENT_LARGE
    use_native = verify and native.available()

    def roundtrips(L, base, orig):
        # the LF walk of (L, base) yields the block in its ORIGINAL
        # orientation: the reversal is part of the format convention
        return _inverse(L, base, sentinel, use_native).tobytes() == orig

    fetched = []  # (L, base, verify future or None)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:

        def fetch(item):
            if item is None:
                return np.zeros(0, np.uint8), 0, None
            orig, L, base = item
            L = L.cpu().numpy()
            return L, base, pool.submit(roundtrips, L, base, orig) if verify else None

        pending = deque()
        for b in blocks:
            if len(b) == 0:
                pending.append(None)
            else:
                arr = torch.from_numpy(np.frombuffer(b[::-1], np.uint8).copy()).to(dev)
                pending.append((b, *bwt_v3(arr, sentinel)))
            if len(pending) > PIPE_BLOCKS:
                fetched.append(fetch(pending.popleft()))
        while pending:
            fetched.append(fetch(pending.popleft()))
        bad = [i for i, (_, _, ok) in enumerate(fetched) if ok is not None and not ok.result()]
    if bad:
        raise AssertionError(f"round-trip verification failed for block(s) {bad} (internal error)")
    return [(L, base) for (L, base, _ok) in fetched]


def encode_file(
    data: bytes,
    generation: str = "a4",
    block_size: int = DEFAULT_BLOCK,
    verify: bool = True,
    pack: bool = False,
    device="cuda",
) -> bytes:
    """Encode ``data`` into the blocked container, byte-identical with
    ``archon_tpu.encode_file(..., impl="stream")``.  ``pack=True`` writes
    the compressing ATA2 container (MTF+RLE0+Huffman payloads)."""
    if generation not in GENERATIONS:
        raise ValueError(f"unknown generation {generation!r}")
    if block_size < 1:
        raise ValueError("block_size must be positive")
    header = (MAGIC_PACKED if pack else MAGIC) + struct.pack(
        "<BBHI", GENERATIONS[generation], FLAG_PACKED if pack else 0, 0, block_size
    )
    blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)] or [b""]
    results = _streamed_forward(blocks, generation, verify, device)
    chunks = [header]
    if pack:
        native.available()  # build the host library before the pack pool starts
        for (_L, base), blk, payload in zip(results, blocks, _pack_payloads(results)):
            chunks += [struct.pack("<II", len(blk), len(payload)), payload, struct.pack("<I", base)]
    else:
        for (L, base), blk in zip(results, blocks):
            chunks += [struct.pack("<I", len(blk)), L.tobytes(), struct.pack("<I", base)]
    return b"".join(chunks)


def decode_file(blob: bytes, strict: bool = True, on_error=None) -> bytes:
    """Invert an ATA1/ATA2 container on the host.  ``strict=False`` isolates
    faults per block: a corrupt block (bad base, bad packed payload, or an
    LF walk that is not one cycle) decodes to zero bytes and is reported
    through ``on_error(block_index, exception)``."""
    packed = blob[:4] == MAGIC_PACKED
    if blob[:4] != MAGIC and not packed:
        raise ValueError("bad magic")
    gen_id, _flags, _rsvd, _block_size = struct.unpack("<BBHI", blob[4:12])
    sentinel = SENT_SMALL if gen_id == 0 else SENT_LARGE
    use_native = native.available()

    parsed = []  # (index, L-or-packed-payload, base, n)
    pos = 12
    while pos < len(blob):
        if packed:
            n, plen = struct.unpack("<II", blob[pos : pos + 8])
            payload = blob[pos + 8 : pos + 8 + plen]
            pos += 8 + plen
        else:
            (n,) = struct.unpack("<I", blob[pos : pos + 4])
            payload = np.frombuffer(blob[pos + 4 : pos + 4 + n], np.uint8)
            pos += 4 + n
        (base,) = struct.unpack("<I", blob[pos : pos + 4])
        pos += 4
        parsed.append((len(parsed), payload, base, n))

    def decode_one(item):
        idx, L, base, n = item
        if not n:
            return b""
        try:
            if packed:
                L = unpack_block(L, n)
            if base >= n:
                raise ValueError(f"block {idx}: base {base} out of range")
            if not strict and use_native and not native.verify_cycle(
                L, base, sentinel == SENT_LARGE
            ):
                raise ValueError(f"block {idx}: LF walk is not a single cycle")
            return _inverse(L, base, sentinel, use_native).tobytes()
        except ValueError as e:
            if strict:
                raise
            if on_error is not None:
                on_error(idx, e)
            return b"\x00" * n

    if len(parsed) > 1:
        # the native walk releases the GIL: blocks decode on all cores
        with ThreadPoolExecutor(max_workers=min(len(parsed), os.cpu_count() or 1)) as ex:
            return b"".join(ex.map(decode_one, parsed))
    return b"".join(decode_one(it) for it in parsed)
