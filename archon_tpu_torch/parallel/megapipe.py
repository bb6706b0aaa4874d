"""End-to-end sharded megablock pipeline: SA -> BWT -> entropy, on the mesh
(port of ``archon_tpu/parallel/megapipe.py``; names and structure kept).

One megablock is text-sharded over the 'sp' mesh axis, suffix-sorted by
distributed doubling (parallel.megablock), its BWT emitted sharded (the
prev-byte payload rides the final merge-split sort), and Huffman-packed per
shard with one shared table.

Container format (the JAX package's, byte for byte):

    header: magic b'ATM1' | u8 generation (0=a4-small, 1=a7-large)
            | u8 coder (0=byte, 1=var) | u16 n_shards | u64 n | u32 base
            | u32 pad (trailing filler bytes appended pre-transform so n
              divides the shard count; stripped after inverse)
    table : 256 x u32 symbol histogram of L (the Huffman build is
            deterministic, entropy/huffman.py, so the decoder rebuilds the
            exact table from the histogram)
    shard : u32 nbits | ceil(nbits/8) payload bytes      (x n_shards)

Per-shard frames are byte-aligned independently.  The bytes depend on the
shard count (the frames and the filler do), not on how the shards are laid
over devices.

Decode is host-side: rebuild table -> per-shard backward Huffman walk ->
native inverse BWT (without the native library: the port's
``core.unbwt.bwt_inverse`` on CPU tensors).
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..core.doubling import SENT_LARGE, SENT_SMALL
from ..entropy.huffman import SymbolCode, build_encoder_byte, build_encoder_var
from ..ops.bitpack import pack_codes_sized
from ..utils.timing import span
from .blocks import Mesh
from .collectives import collectives
from .megablock import AXIS, _make_emit, _rank_mesh, _sharded_ranks

MAGIC = b"ATM1"
GENERATIONS = {"a4": 0, "a7": 1}
CODERS = {"byte": 0, "var": 1}
CODER_NAMES = {v: k for k, v in CODERS.items()}


def _make_hist(mesh: Mesh):
    """Sharded 256-bin histogram (psum of per-shard bincounts)."""
    coll = collectives(mesh, AXIS)

    def hist_fn(L_shard):
        rows = torch.arange(L_shard.shape[0], dtype=torch.int32, device=L_shard.device)[:, None]
        bins = (L_shard.to(torch.int32) + rows * 256).reshape(-1)
        h = torch.bincount(bins, minlength=256 * L_shard.shape[0]).view(-1, 256)
        return coll.psum(h.to(torch.int32))

    return hist_fn


def _make_pack(mesh: Mesh, max_len: int):
    """Per-shard parallel bit-pack with the shared (replicated) code table:
    (rows, W) words (int64 holding u32 values) and (rows,) bit totals."""

    def pack_fn(L_shard, values, lengths):
        packed = [pack_codes_sized(row, values, lengths, max_len) for row in L_shard]
        return (torch.stack([words for words, _ends, _total in packed]),
                torch.stack([total for _words, _ends, total in packed]))

    return pack_fn


def _codes_arrays(codes: list[SymbolCode]):
    values = np.array([c.code for c in codes], np.uint32)
    lengths = np.array([c.length for c in codes], np.int32)
    return values, lengths


def encode_megablock(
    data: bytes,
    mesh: Mesh,
    generation: str = "a4",
    coder: str = "var",
) -> bytes:
    """Sharded encode of one megablock of any length: inputs that do not
    divide the shard count are padded with a deterministic non-repetitive
    filler (recorded in the header, stripped on decode: an all-zero pad
    would hand the suffix sorter a pathological tie run for free)."""
    if generation not in GENERATIONS:
        raise ValueError(f"unknown generation {generation!r}")
    if coder not in CODERS:
        raise ValueError(f"unknown coder {coder!r}")
    ns = mesh.shape[AXIS]
    arr = np.frombuffer(bytes(data), np.uint8)
    pad = (-len(arr)) % ns
    if pad:
        filler = (
            (np.arange(pad, dtype=np.uint64) * 2654435761) >> 20
        ).astype(np.uint8)
        arr = np.concatenate([arr, filler])
    n = len(arr)
    sentinel = SENT_SMALL if generation == "a4" else SENT_LARGE
    # right-to-left comparisons = forward sort of the reversed text (the
    # same convention io.blocks uses for its per-block framing, both gens)
    view = arr[::-1]

    rank, data_dev, S, n = _sharded_ranks(view, mesh, sentinel)
    with span("archon.megablock.emit"):
        L_dev, base = _make_emit(mesh, S, n)(rank, data_dev)
        del rank, data_dev
        base = int(base)

    with span("archon.megablock.hist"):
        hist = _make_hist(mesh)(L_dev).cpu().numpy()
        if coder == "var":
            codes = build_encoder_var(hist)
        else:
            codes = build_encoder_byte()
        values, lengths = _codes_arrays(codes)
        max_len = int(lengths.max()) if lengths.size else 1
        max_len = max(max_len, 1)

    with span("archon.megablock.pack"):
        dev = L_dev.device
        words2, totals = _make_pack(mesh, max_len)(
            L_dev, torch.from_numpy(values.astype(np.int64)).to(dev), torch.from_numpy(lengths).to(dev)
        )
        coll = collectives(mesh, AXIS)
        totals = coll.all_gather(totals)[0].cpu().numpy()
        # only the words that hold bits leave the device, and as 32-bit ones: the
        # words are int64 holding u32 values, and the cast to int32 keeps their
        # low 32 bits, which the host then reads as u32
        used = max((int(totals.max()) + 31) // 32, 1)
        words2 = coll.all_gather(words2[:, :used].to(torch.int32))[0].cpu().numpy().view(np.uint32)

        out = [
            MAGIC,
            struct.pack(
                "<BBHQII", GENERATIONS[generation], CODERS[coder], ns, n, base, pad
            ),
            hist.astype(np.uint32).tobytes(),
        ]
        for s in range(ns):
            nbits = int(totals[s])
            nbytes = (nbits + 7) // 8
            out.append(struct.pack("<I", nbits))
            out.append(words2[s].tobytes()[:nbytes])
        return b"".join(out)


def _encode_on_rank(rank: int, world: int, data: bytes, device_type: str, generation: str,
                    coder: str) -> bytes:
    """``encode_megablock`` as rank ``rank`` of ``world`` (the entry that
    ``collectives.spawn`` runs, one shard a rank): every rank returns the
    whole blob."""
    return encode_megablock(data, _rank_mesh(world, device_type), generation, coder)


def decode_megablock(blob: bytes) -> bytes:
    """Host-side inverse of :func:`encode_megablock` (container recovery
    path): per-shard entropy decode, concatenate L, native inverse BWT."""
    if blob[:4] != MAGIC:
        raise ValueError("bad magic")
    gen_id, coder_id, ns, n, base, pad = struct.unpack("<BBHQII", blob[4:24])
    pos = 24
    hist = np.frombuffer(blob[pos : pos + 1024], np.uint32)
    pos += 1024
    if CODER_NAMES[coder_id] == "var":
        codes = build_encoder_var(hist)
    else:
        codes = build_encoder_byte()
    S = n // ns
    use_native = native.available()

    if not any(c.length for c in codes):
        # single-symbol alphabet: the Huffman code is zero-length and the
        # stream is empty, so L is just the one present symbol repeated
        sym = int(np.argmax(hist))
        L = np.full(n, sym, np.uint8)
    else:
        frames = []  # (nbits, stream_bytes) per shard
        for _ in range(ns):
            (nbits,) = struct.unpack("<I", blob[pos : pos + 4])
            pos += 4
            nbytes = (nbits + 7) // 8
            frames.append((nbits, np.frombuffer(blob[pos : pos + nbytes], np.uint8)))
            pos += nbytes
        if use_native:
            # native first-bits decoder, thread-pooled per shard: bitunpack
            # releases the GIL, so shards decode on all cores
            vals = np.array([c.code for c in codes], np.uint32)
            lens = np.array([c.length for c in codes], np.uint8)

            def unpack_one(frame):
                nbits, stream = frame
                nwords = (nbits + 31) // 32
                buf = np.zeros((nwords + 2) * 4, np.uint8)
                buf[: len(stream)] = stream
                return native.bitunpack(buf.view(np.uint32), nbits, vals, lens, S)

            if ns > 1:
                with ThreadPoolExecutor(max_workers=min(ns, os.cpu_count() or 1)) as ex:
                    parts = list(ex.map(unpack_one, frames))
            else:
                parts = [unpack_one(frames[0])]
        else:
            from ..entropy.coder import decode_stream

            parts = [decode_stream(stream, nbits, codes, S) for nbits, stream in frames]
        L = np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    if use_native:
        out = native.unbwt(L, base, gen_id == 1).tobytes()
    else:
        from ..core.unbwt import bwt_inverse

        rt = bwt_inverse(torch.from_numpy(L.copy()), base, SENT_SMALL if gen_id == 0 else SENT_LARGE)
        out = rt.numpy().tobytes()
    return out[: n - pad] if pad else out
