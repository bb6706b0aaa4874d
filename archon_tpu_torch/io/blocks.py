"""Block-streamed container, ATA1/ATA2 (port of ``archon_tpu/io/blocks.py``).

    header: magic b'ATA1' | u8 generation (0=a4, 1=a7) | u8 flags
            | u16 reserved | u32 block_size
    block : u32 n | n payload bytes | u32 base                    (ATA1)
            u32 n | u32 plen | packed payload | u32 base          (ATA2)

Each block is reversed and transformed on the device, and its (L, base)
written as one frame; ``pack=True`` entropy-packs each L (``entropy.pack``):
on the card where the batched program left it (``RowPack``), and on the
host for every other row (L on the CPU, the fallback, the stream, empty
blocks).  The device program is chosen by ``impl``:

- ``micro`` (the default, as in the JAX package): equal-length blocks stacked
  into (B, n) batches through ``core.batched.bwt_batched_micro*``, rows it
  could not resolve recomputed by ``_fallback_row``;
- ``v3``: the batched program with its cascade inside, no fallback;
- ``stream``: block by block through ``core.fast2.bwt_v3``;
- ``it2``: block by block through ``core.it2.bwt_it2_async``, a block it
  flags recomputed by ``bwt_v3``.

All four write the same bytes.  ``dp > 1`` splits each batch of ``micro`` and
``v3`` over a ``dp`` device mesh (``parallel.blocks.make_mesh``); the stream
ignores it.  ``encode_to_path`` appends frames to a file and can resume an
interrupted encode; ``extract_block`` cuts one block out as a single-block
a4/a7 blob.  Decode is the native LF walk.  The sharded megablock container
(``ATM1``) is ``parallel.megapipe``'s: ``decode_file`` and ``extract_block``
name it and point there.
"""

from __future__ import annotations

import os
import struct
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..core.doubling import SENT_LARGE, SENT_SMALL
from ..entropy.pack import RowPack, pack_block, unpack_block
from ..golden import sa as golden
from ..utils.timing import span

__all__ = ["encode_file", "encode_to_path", "decode_file", "extract_block", "as_device",
           "as_byte_tensor",
           "host_walk", "DEFAULT_BLOCK"]

MAGIC = b"ATA1"
MAGIC_PACKED = b"ATA2"  # per-block MTF+RLE0+Huffman payloads (entropy/pack)
MAGIC_MEGABLOCK = b"ATM1"  # the sharded megablock container (parallel.megapipe)
GENERATIONS = {"a4": 0, "a7": 1}
DEFAULT_BLOCK = 1 << 22  # 4 MiB, the x1 historical default (ArchonX1.c:19)
FLAG_PACKED = 1

# Dispatch-unit size in blocks.  The stream keeps at most this many results
# on the device before the oldest is copied back; the batched path cuts
# equal-length runs into units of this many rows.  ARCHON_PIPE_BLOCKS
# overrides it (0: all blocks in one window or unit).
PIPE_BLOCKS = 8


def _pipe_blocks(count: int) -> int:
    return int(os.environ.get("ARCHON_PIPE_BLOCKS", PIPE_BLOCKS)) or count


def as_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a usable card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is false")
    return dev


def as_byte_tensor(data, device) -> torch.Tensor:
    """Bytes or a numpy uint8 array (of any shape) as a uint8 tensor on
    ``device``, through ``as_device``."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(bytes(data), np.uint8)
    return torch.from_numpy(np.array(arr, np.uint8)).to(as_device(device))


def host_walk() -> str:
    """The host LF walk that verify and decode use: ``"native"`` (the C++
    library, built on first call) or ``"golden"`` (the numpy model, taken
    when no C++ toolchain is found, and orders of magnitude slower)."""
    return "native" if native.available() else "golden"


def _inverse(L: np.ndarray, base: int, sentinel: str, use_native: bool) -> np.ndarray:
    """Host LF walk: the native one, or the golden model without a toolchain
    (``use_native = native.available()``, decided once per call by the
    caller)."""
    if use_native:
        return native.unbwt(L, base, sentinel == SENT_LARGE)
    return golden.bwt_inverse(L, base, sentinel)


def _streamed_forward(blocks: list[bytes], generation: str, verify: bool, device,
                      use_it2: bool = False) -> list:
    """Per-block forward BWT stream (``impl="stream"``): each block runs
    ``bwt_v3`` on ``device``, exact for every input, so no fallback rows
    exist; at most ``PIPE_BLOCKS`` results stay on the device before the
    oldest is copied back, bounding device memory to O(window * block).

    ``use_it2`` (``impl="it2"``) sends each block through the IT-2
    reduced-volume candidate instead (``core.it2.bwt_it2_async``): a window
    of blocks is enqueued before the oldest is resolved, and a block whose
    static caps cannot resolve it exactly (``ok`` false at finish time) is
    recomputed through ``bwt_v3`` and counted in
    ``_streamed_forward.it2_fallbacks``.

    ``verify=True`` round-trips every block through the host LF walk
    (``native.unbwt(L, base) == block``) on a thread pool, each block as soon
    as its L is on the host, so the walks overlap the device work of the
    blocks after it."""
    from ..core.fast2 import bwt_v3

    dev = as_device(device)
    sentinel = SENT_SMALL if generation == "a4" else SENT_LARGE
    use_native = verify and native.available()
    window = _pipe_blocks(len(blocks))

    if use_it2:
        from ..core.it2 import bwt_it2_async

        def dispatch(arr):
            return bwt_it2_async(arr, sentinel)

        def resolve(arr, finish):
            L, base, ok = finish()
            if ok:
                return L, base
            _streamed_forward.it2_fallbacks += 1
            return bwt_v3(arr, sentinel)
    else:
        def dispatch(arr):
            return bwt_v3(arr, sentinel)

        def resolve(arr, out):
            return out

    def roundtrips(L, base, orig):
        # the LF walk of (L, base) yields the block in its ORIGINAL
        # orientation: the reversal is part of the format convention
        return _inverse(L, base, sentinel, use_native).tobytes() == orig

    fetched = []  # (L, base, verify future or None)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:

        def fetch(item):
            if item is None:
                return np.zeros(0, np.uint8), 0, None
            orig, arr, out = item
            L, base = resolve(arr, out)
            L = L.cpu().numpy()
            return L, base, pool.submit(roundtrips, L, base, orig) if verify else None

        pending = deque()
        for b in blocks:
            if len(b) == 0:
                pending.append(None)
            else:
                arr = _reversed_on(dev, [b])[0]
                pending.append((b, arr, dispatch(arr)))
            if len(pending) > window:
                fetched.append(fetch(pending.popleft()))
        while pending:
            fetched.append(fetch(pending.popleft()))
        bad = [i for i, (_, _, ok) in enumerate(fetched) if ok is not None and not ok.result()]
    if bad:
        raise AssertionError(f"round-trip verification failed for block(s) {bad} (internal error)")
    return [(L, base) for (L, base, _ok) in fetched]


_streamed_forward.it2_fallbacks = 0  # blocks it2 flagged and bwt_v3 recomputed, since import


def _reversed_on(dev: torch.device, blks) -> torch.Tensor:
    """Equal-length blocks as the rows of a (B, n) uint8 tensor on ``dev``,
    each reversed (the format transforms the reversed block).  The copy to
    the device is of the bytes as they are; the reversal runs there."""
    with span("archon.container.stage_in"):
        batch = np.stack([np.frombuffer(b, np.uint8) for b in blks])
        return torch.from_numpy(batch).to(dev).flip(1)


def _fallback_row(block: bytes, sentinel: str, verify: bool, device):
    """Recompute one block through the 1-D cascade path
    (``core.fast2.bwt_forward_v2``): the way out for rows the fast batched
    program could not resolve (residues of more than 4096 actives or ties
    deeper than 16k, e.g. long exact periods)."""
    from ..core.batched import verify_bwt_batched
    from ..core.fast2 import bwt_forward_v2

    arr = _reversed_on(device, [block])[0]
    L, base, rank = bwt_forward_v2(arr, sentinel)
    if verify:
        base2 = torch.tensor([base], dtype=torch.int32, device=arr.device)
        if not bool(verify_bwt_batched(arr[None], rank[None], L[None], base2, sentinel)[0]):
            raise AssertionError("BWT verification failed on fallback block (internal error)")
    _fallback_row.calls += 1
    return L.cpu().numpy(), base


_fallback_row.calls = 0  # rows recomputed since import (or since a caller set it to 0)


def _packs_on_device(L: torch.Tensor) -> bool:
    """Whether a unit's rows pack where they lie (``RowPack``): on a card.
    Rows on the CPU pack on the host pool (``pack_block``), which outruns
    the device pack's plain twins there many times over."""
    return L.is_cuda


def _batched_forward(blocks: list[bytes], generation: str, verify: bool = True,
                     impl: str = "micro", device="cuda", mesh=None, pack: bool = False) -> list:
    """Transform blocks, batching equal-length runs: [(L, base), ...].

    ``verify=True`` (default) runs the per-block LF certificate on the
    device for ``micro`` and ``v3``, and the host round trip for ``stream``
    and ``it2``.

    The device program is the cascade-free fast path by default
    (``impl="micro"``, ``core.batched.bwt_batched_micro*``): rows it reports
    unresolved are recomputed through the 1-D cascade pipeline.
    ``impl="v3"`` selects the variant with the cascade inside (no fallback).
    ``mesh`` dp-shards each unit over its devices (the unit's rows are laid
    on ``device`` first; ``parallel.blocks`` moves each chunk to its own).

    Equal-length runs are cut into dispatch units of ``PIPE_BLOCKS`` rows;
    unit i+1 is enqueued before unit i's payload is copied back.

    ``pack=True`` (``micro`` and ``v3``) packs each unit's rows on the card
    where they lie (``entropy.pack.RowPack``, enqueued right after the
    unit): a row the program resolved comes back as its ATA2 payload (bytes)
    in place of L, and only the packed words (or, for a row stored raw, L)
    are copied back.  Rows left to the fallback, and units on the CPU, come
    back as L."""
    from ..parallel.blocks import (
        bwt_blocks,
        bwt_blocks_certified,
        bwt_blocks_micro,
        bwt_blocks_micro_certified,
    )

    if impl == "stream":
        return _streamed_forward(blocks, generation, verify, device)
    if impl == "it2":
        return _streamed_forward(blocks, generation, verify, device, use_it2=True)
    if impl not in ("micro", "v3"):
        raise ValueError(f"unknown impl {impl!r}")
    dev = as_device(device)
    sentinel = SENT_SMALL if generation == "a4" else SENT_LARGE
    pipe = _pipe_blocks(len(blocks))
    if mesh is not None:
        # a dispatch unit must stay shardable over the dp mesh
        pipe = -(-pipe // mesh.size) * mesh.size

    # split into dispatch units: equal-length runs, chunked to `pipe` rows
    units = []  # (first_index, [block bytes...]); empty blocks pass through
    i = 0
    while i < len(blocks):
        if len(blocks[i]) == 0:
            units.append((i, None))
            i += 1
            continue
        j = i
        while j < len(blocks) and len(blocks[j]) == len(blocks[i]):
            j += 1
        for s in range(i, j, pipe):
            units.append((s, blocks[s : min(s + pipe, j)]))
        i = j

    def dispatch(unit):
        first, blks = unit
        if blks is None:
            return ()
        with span("archon.container.dispatch"):
            data2 = _reversed_on(dev, blks)
            ones = torch.ones(len(blks), dtype=torch.bool)
            # a ragged tail batch (rows the mesh does not divide) runs unsharded
            m = mesh if mesh is not None and len(blks) % mesh.size == 0 else None
            if impl == "v3":
                if verify:
                    L, base, ok = bwt_blocks_certified(data2, sentinel, mesh=m)
                else:
                    (L, base), ok = bwt_blocks(data2, sentinel, mesh=m), ones
                resolved = ones
            elif verify:
                L, base, ok, resolved = bwt_blocks_micro_certified(data2, sentinel, mesh=m)
            else:
                L, base, resolved = bwt_blocks_micro(data2, sentinel, mesh=m)
                ok = resolved
            packer = RowPack(L) if pack and _packs_on_device(L) else None
            return first, blks, L, base, ok, resolved, packer

    def fallback(block):
        with span("archon.container.fallback"):
            return _fallback_row(block, sentinel, verify, dev)

    def collect(handle):
        if not handle:
            return [(np.zeros(0, np.uint8), 0)]
        with span("archon.container.collect"):
            first, blks, L, base, ok, resolved, packer = handle
            if packer is not None:
                packer.plan()  # the Huffman builds, while the card runs the next unit
            resolved = resolved.cpu().numpy()
            ok = ok.cpu().numpy()
            if verify and not (ok | ~resolved).all():
                bad = [first + t for t in np.nonzero(~ok & resolved)[0].tolist()]
                raise AssertionError(f"BWT verification failed for block(s) {bad} (internal error)")
            if packer is None:
                got = L.cpu().numpy()
            else:  # each resolved row's payload in place of its L
                rows = np.nonzero(resolved)[0].tolist()
                got = dict(zip(rows, packer.payloads(rows)))
            base = base.cpu().numpy()
            return [(got[t], int(base[t])) if resolved[t] else fallback(blks[t]) for t in range(len(blks))]

    out = []
    prev = None
    for unit in units:
        cur = dispatch(unit)  # enqueued before prev's payload is copied back
        if prev is not None:
            out.extend(collect(prev))
        prev = cur
    if prev is not None:
        out.extend(collect(prev))
    return out


def _pack_payloads(results: list) -> list[bytes]:
    """Each block's ATA2 payload: a payload the device packed (bytes in
    place of L) as it is, every other L packed on the host thread pool (the
    native MTF/RLE0/bitpack calls release the GIL, so blocks pack on all
    cores)."""
    items = [L for (L, _base) in results if not isinstance(L, bytes)]
    if len(items) > 1:
        with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 1)) as ex:
            packed = list(ex.map(pack_block, items))
    else:
        packed = [pack_block(L) for L in items]
    packed = iter(packed)
    return [L if isinstance(L, bytes) else next(packed) for (L, _base) in results]


def _header(generation: str, block_size: int, pack: bool) -> bytes:
    return (MAGIC_PACKED if pack else MAGIC) + struct.pack(
        "<BBHI", GENERATIONS[generation], FLAG_PACKED if pack else 0, 0, block_size
    )


def _frames(blocks, results, pack: bool):
    """The container frames of ``blocks`` from their (L, base) results, each
    a tuple of bytes-like pieces (L itself, not a copy of it: the caller
    joins or writes the pieces)."""
    if pack:
        with span("archon.pack.blocks"):
            payloads = _pack_payloads(results)
        for (_L, base), blk, payload in zip(results, blocks, payloads):
            yield struct.pack("<II", len(blk), len(payload)), payload, struct.pack("<I", base)
    else:
        for (L, base), blk in zip(results, blocks):
            yield struct.pack("<I", len(blk)), np.ascontiguousarray(L).data, struct.pack("<I", base)


def _check_args(generation: str, block_size: int) -> None:
    if generation not in GENERATIONS:
        raise ValueError(f"unknown generation {generation!r}")
    if block_size < 1:
        raise ValueError("block_size must be positive")


def _dp_mesh(dp: int, device):
    """The ``dp`` mesh of ``encode_file``: None for ``dp <= 1``; the first
    ``dp`` cards for a CUDA device (raises, naming the count, where there are
    fewer); ``dp`` entries of any other device (the CPU takes any ``dp``)."""
    if dp <= 1:
        return None
    from ..parallel.blocks import make_mesh

    dev = as_device(device)
    if dev.type != "cuda":
        return make_mesh({"dp": dp}, devices=[dev] * dp)
    cards = torch.cuda.device_count()
    if cards < dp:
        raise RuntimeError(f"dp={dp} needs {dp} CUDA devices, this machine has {cards}")
    return make_mesh({"dp": dp}, devices=[torch.device("cuda", i) for i in range(dp)])


def _reject_megablock(blob: bytes) -> None:
    if blob[:4] == MAGIC_MEGABLOCK:
        raise ValueError(
            "bad magic: an ATM1 container is one sharded megablock, not a block stream; "
            "parallel.megapipe.decode_megablock reads it (as does the command line's d)"
        )


def _split(data: bytes, block_size: int) -> list[bytes]:
    return [data[i : i + block_size] for i in range(0, len(data), block_size)] or [b""]


def encode_file(
    data: bytes,
    generation: str = "a4",
    block_size: int = DEFAULT_BLOCK,
    verify: bool = True,
    impl: str = "micro",
    dp: int = 1,
    pack: bool = False,
    device="cuda",
) -> bytes:
    """Encode ``data`` into the blocked container, byte-identical with
    ``archon_tpu.encode_file``.  ``impl`` selects the device program (micro:
    cascade-free batched fast path; v3: batched with the cascade inside;
    stream: block by block; it2: block by block through the IT-2 candidate
    with its ``bwt_v3`` fallback; all write the same bytes).  ``verify`` is
    the device LF certificate for micro and v3 and the host round trip for
    stream and it2.  ``pack=True`` writes the compressing ATA2 container
    (MTF+RLE0+Huffman payloads).  ``dp > 1`` shards the block batch of micro
    and v3 over a dp-axis device mesh (``_dp_mesh``; stream and it2 ignore it,
    their blocks pipeline through one device's queue)."""
    _check_args(generation, block_size)
    mesh = _dp_mesh(dp, device)
    with span("archon.container.split"):
        blocks = _split(data, block_size)
    results = _batched_forward(blocks, generation, verify, impl, device, mesh, pack=pack)
    with span("archon.container.frames"):
        pieces = [_header(generation, block_size, pack)]
        for frame in _frames(blocks, results, pack):
            pieces += frame
        return b"".join(pieces)


def _scan_complete_blocks(path, generation: str, block_size: int, expect_lens=None):
    """Number of COMPLETE frames in a (possibly truncated) container at
    ``path``, the byte offset just past the last complete frame, the offset
    of that last frame's header, and whether the container is packed.
    Returns None if the file is missing or invalid or its header disagrees.

    ``expect_lens`` (the current input's block lengths) bounds the scan: a
    frame whose stored n disagrees with the input's block length (the input
    changed since the partial encode) stops the scan at the last frame that
    still fits, so stale frames beyond a SHRUNK input are truncated away
    rather than silently kept."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return None
    if size < 12:
        return None
    with open(path, "rb") as f:
        head = f.read(12)
        packed = head[:4] == MAGIC_PACKED
        if head[:4] != MAGIC and not packed:
            return None
        gen_id, _flags, _rsvd, bs = struct.unpack("<BBHI", head[4:12])
        if gen_id != GENERATIONS[generation] or bs != block_size:
            return None
        pos, count, last = 12, 0, 12
        while True:
            hdr = f.read(8 if packed else 4)
            if len(hdr) < (8 if packed else 4):
                break
            if packed:
                n, plen = struct.unpack("<II", hdr)
                frame = 12 + plen
            else:
                (n,) = struct.unpack("<I", hdr)
                plen = n
                frame = 8 + n
            if pos + frame > size:
                break
            if expect_lens is not None and (count >= len(expect_lens) or n != expect_lens[count]):
                break
            f.seek(plen + 4, 1)
            last = pos
            pos += frame
            count += 1
    return count, pos, last, packed


def _last_frame_matches(path, frame_start: int, frame_end: int, generation: str, block: bytes,
                        packed: bool = False) -> bool:
    """Round-trip the frame at [frame_start, frame_end) against ``block``:
    the input-drift guard of resume.  A partial encode whose INPUT changed
    since (same lengths, different bytes) would otherwise keep stale frames
    that silently decode to wrong data; decoding the last kept frame and
    comparing bytes catches the drift at the resume point, for one block's
    host walk (``native.unbwt``, which walks with the golden model when the
    library is missing)."""
    with open(path, "rb") as f:
        f.seek(frame_start)
        raw = f.read(frame_end - frame_start)
    head = 8 if packed else 4
    if len(raw) < head + 4:
        return False
    if packed:
        n, plen = struct.unpack("<II", raw[:8])
    else:
        (n,) = struct.unpack("<I", raw[:4])
        plen = n
    if n != len(block) or len(raw) != head + plen + 4:
        return False
    try:
        payload = raw[head : head + plen]
        L = unpack_block(payload, n) if packed else np.frombuffer(payload, np.uint8)
        (base,) = struct.unpack("<I", raw[head + plen :])
        if n == 0:
            return True
        if base >= n:
            return False
        return native.unbwt(L, base, generation != "a4").tobytes() == block
    except ValueError:
        return False


def encode_to_path(
    data: bytes,
    path,
    generation: str = "a4",
    block_size: int = DEFAULT_BLOCK,
    resume: bool = False,
    flush_blocks: int = 16,
    verify: bool = True,
    impl: str = "micro",
    pack: bool = False,
    device="cuda",
) -> int:
    """Streaming encode with checkpoint/resume at block granularity.

    Frames are appended and flushed every ``flush_blocks`` blocks, so the
    prefix on disk is always a valid container of complete blocks.  With
    ``resume=True`` an interrupted output is scanned, any trailing partial
    frame is truncated away, and encoding continues from the first missing
    block; an output whose kind, header or last kept frame disagrees with
    the input is written anew.  Returns the number of blocks (re)computed."""
    _check_args(generation, block_size)
    blocks = _split(data, block_size)
    done = 0
    state = (
        _scan_complete_blocks(path, generation, block_size, [len(b) for b in blocks])
        if resume
        else None
    )
    if state is not None:
        done, keep, last, was_packed = state
        if was_packed != pack:
            state, done = None, 0  # container kind changed: restart
        elif done > 0 and not _last_frame_matches(
            path, last, keep, generation, blocks[done - 1], packed=pack
        ):
            # the input drifted since the partial encode: stale frames would
            # silently decode to the OLD data, so restart from scratch
            state, done = None, 0
    if state is not None:
        with open(path, "r+b") as f:
            f.truncate(keep)
    computed = 0
    with open(path, "ab" if state is not None else "wb") as f:
        if state is None:
            f.write(_header(generation, block_size, pack))
        todo = blocks[done:]
        for i in range(0, len(todo), flush_blocks):
            batch = todo[i : i + flush_blocks]
            results = _batched_forward(batch, generation, verify, impl, device, pack=pack)
            for frame in _frames(batch, results, pack):
                f.writelines(frame)
                computed += 1
            f.flush()
    return computed


def decode_file(blob: bytes, strict: bool = True, on_error=None) -> bytes:
    """Invert an ATA1/ATA2 container on the host (an ``ATM1`` blob raises
    "bad magic", naming ``parallel.megapipe``).  ``strict=False`` isolates
    faults per block: a corrupt block (bad base, bad packed payload, or an
    LF walk that is not one cycle) decodes to zero bytes and is reported
    through ``on_error(block_index, exception)``."""
    _reject_megablock(blob)
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

    if use_native and len(parsed) > 1:
        # the native walk releases the GIL: blocks decode on all cores
        with ThreadPoolExecutor(max_workers=min(len(parsed), os.cpu_count() or 1)) as ex:
            return b"".join(ex.map(decode_one, parsed))
    return b"".join(decode_one(it) for it in parsed)


def extract_block(blob: bytes, index: int) -> bytes:
    """Block ``index`` as a standalone single-block blob (payload + trailing
    u32 base, what the reference a4/a7 decoder reads).  Packed (ATA2) frames
    are entropy-unpacked first, so a block of either container comes out the
    same."""
    _reject_megablock(blob)
    packed = blob[:4] == MAGIC_PACKED
    if blob[:4] != MAGIC and not packed:
        raise ValueError("bad magic")
    pos = 12
    i = 0
    while pos < len(blob):
        if packed:
            n, plen = struct.unpack("<II", blob[pos : pos + 8])
            if i == index:
                L = unpack_block(blob[pos + 8 : pos + 8 + plen], n)
                return L.tobytes() + blob[pos + 8 + plen : pos + 12 + plen]
            pos += 12 + plen
        else:
            (n,) = struct.unpack("<I", blob[pos : pos + 4])
            if i == index:
                return blob[pos + 4 : pos + 8 + n]
            pos += 8 + n
        i += 1
    raise IndexError(index)
