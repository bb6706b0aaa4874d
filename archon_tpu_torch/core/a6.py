"""The a6 generation: an entropy-recoded BWT over codeword-end bit offsets
(port of ``archon_tpu/core/a6.py``; names and structure kept).

Replaces, by function (``archon_tpu/core/a6.py``):

- ``TERMIN_BITS``, ``_check_code_lengths``, ``_code_arrays``,
  ``_uniform_width``, ``_symbol_rank_map``, ``build_codes`` <- ``:32-111``,
  host numpy on the same Huffman/fixed/byte table functions (``entropy/huffman.py``);
- ``_bit_suffix_ranks``     <- ``:114`` (``_bit_suffix_ranks``);
- ``_a6_transform``         <- ``:140`` (``_a6_transform``), the literal
  bit-domain path, kept as the oracle of the symbol path;
- ``_remap256``             <- ``:179`` (``_remap256``);
- ``_a6_symbol_transform``  <- ``:192`` (``_a6_symbol_transform``);
- ``a6_forward``, ``a6_encode``, ``a6_decode``, ``_a6_decode_raw`` <- ``:220-331``.

Every sort goes through ``ops.sort.sort_operands`` (the Hopper tile-sort and
merge-level kernels on a CUDA tensor).  Every entry point that runs on a
device takes ``device`` (default ``"cuda"``) and raises when it is missing.

TPU workaround dropped: the JAX ``_remap256`` maps bytes through the
256-entry table without a gather (a one-hot compare and a masked sum),
because the table gather was slow on the TPU.  Here it is the index
``table[c]``; the one-hot sum selects exactly ``table[c]``, so the output is
the same.

Size limit: the bit path sorts about ``max_len * n + 80`` positions, and the
port's sort takes widths below 2^30, so it raises ``ValueError`` for
n >= 2^30 / max_len.  The symbol path sorts n positions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..entropy.huffman import build_encoder_byte, build_encoder_fixed, build_encoder_var
from ..entropy.order import order_table
from ..io.blocks import as_device
from ..ops.bitpack import pack_codes_sized, words_to_bits
from ..ops.sort import MAX_WIDTH, sort_operands
from .doubling import SENT_LARGE
from .fast2 import bwt_v3_payload, suffix_ranks_windows
from .unbwt import bwt_inverse, bwt_inverse_with_starts

TERMIN_BITS = 80
_I32 = torch.int32


def _check_code_lengths(codes) -> None:
    """Both code paths assume codeword length <= 32 (the reference's
    MAX_CODE_LENGTH): ``_symbol_rank_map`` shifts by (32 - length) and the
    packer's u32 words cannot hold a longer code.  A skewed input of about
    9 MB or more can reach a deeper Huffman tree: raise."""
    worst = max(c.length for c in codes)
    if worst > 32:
        raise ValueError(
            f"Huffman code length {worst} exceeds the 32-bit format limit "
            "(MAX_CODE_LENGTH); this input's symbol distribution is too "
            "skewed for the a6 format"
        )


def _code_arrays(codes, device):
    """(code values as int64 holding u32, code lengths int32) on ``device``."""
    _check_code_lengths(codes)
    vals = torch.tensor([c.code for c in codes], dtype=torch.int64, device=device)
    lens = torch.tensor([c.length for c in codes], dtype=_I32, device=device)
    return vals, lens


def _uniform_width(codes, freq) -> int:
    """Code width W if every present symbol has the same length <= 8, else 0."""
    lens = {codes[i].length for i in range(256) if freq[i]}
    if len(lens) == 1:
        (w,) = lens
        if 1 <= w <= 8:
            return w
    return 0


def _symbol_rank_map(codes) -> np.ndarray:
    """Dense symbol order under MSB-first codeword comparison: the map that
    reduces the bit-domain sort to an n-symbol sort.  Prefix-free codes
    differ within min(length) bits, so two selected bit suffixes always
    compare at symbol granularity, in the order of left-aligned codeword
    values (the JAX docstring gives the full argument)."""
    _check_code_lengths(codes)
    keys = np.full(256, np.iinfo(np.int64).max, np.int64)
    for s in range(256):
        if codes[s].length:
            keys[s] = np.int64(codes[s].code) << (32 - codes[s].length)
    order = np.argsort(keys, kind="stable")
    rank_map = np.empty(256, np.uint8)
    rank_map[order] = np.arange(256, dtype=np.uint8)
    return rank_map


def build_codes(data: np.ndarray, config: str):
    freq = np.bincount(data, minlength=256)
    if config == "byte":
        return build_encoder_byte()
    if config == "fix":
        return build_encoder_fixed(freq)[0]
    if config == "var":
        return build_encoder_var(freq)
    raise ValueError(f"bad a6 config {config!r}")


def _bit_suffix_ranks(rev_padded: torch.Tensor) -> torch.Tensor:
    """Ranks of all suffixes of the padded reversed bit string (uint8 0/1,
    TERMIN ones appended; off-end sentinel large).  16-position windows are
    base-3 digit packs with an explicit off-end digit 2 (a 1-padded bit pack
    would tie distinct suffixes inside a trailing all-ones run); 3^16 < 2^31
    keeps them int32."""
    m = rev_padded.shape[0]
    ext = torch.cat([rev_padded.to(_I32), torch.full((16,), 2, dtype=_I32, device=rev_padded.device)])
    win = torch.zeros(m, dtype=_I32, device=rev_padded.device)
    for t in range(16):
        win = win * 3 + ext[t : m + t]
    return suffix_ranks_windows(win, 16, SENT_LARGE)


def _a6_transform(data: torch.Tensor, code_values: torch.Tensor, code_lengths: torch.Tensor,
                  max_len: int = 32):
    """a6 forward, variable-width bit path: pack, rank the reversed bit
    stream, select the codeword ends, emit.  ``max_len`` is the table's true
    maximum code length, a host-known int that sizes the bit domain."""
    n = data.shape[0]
    m_cap = ((n * max_len + 31) // 32 + 1) * 32 + TERMIN_BITS  # packer words + TERMIN
    if m_cap >= MAX_WIDTH:
        raise ValueError(
            f"a6 bit path: {n} symbols of up to {max_len} bits need a sort of "
            f"width {m_cap}, past the limit of 2^30"
        )
    words, ends, total = pack_codes_sized(data, code_values, code_lengths, max_len)
    bits = words_to_bits(words)  # only [0, total) is real
    # reversed stream: rev[i] = bits[total-1-i] for i < total, then ones
    # (TERMIN and the padding; only suffixes at positions < total are read)
    src = total - 1 - torch.arange(m_cap, dtype=_I32, device=data.device)
    rev = torch.where(src >= 0, bits[src.clamp(0, bits.shape[0] - 1)], 1).to(torch.uint8)
    rank = _bit_suffix_ranks(rev)

    key = rank[total - ends]  # reversed positions of the codeword ends
    # emission: out[slot] = data[(order[slot] + 1) % n], riding the sort
    _, out = sort_operands((key,), (torch.roll(data, -1),))
    # the codeword end of symbol n-1 is reversed position 0; its slot among
    # the n selected keys is the count of smaller keys
    return out, int((key < key[n - 1]).sum())


def _remap256(c: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """256-entry byte remap: ``table[c]`` (the TPU form is a one-hot sum)."""
    return table[c.long()]


def _a6_symbol_transform(data: torch.Tensor, code_map: torch.Tensor):
    """a6 forward, n-symbol path (every prefix-free table): the SENT_LARGE
    BWT of the recoded reversed text s[j] = code_rank(data[n-1-j]), carrying
    the next original byte, payload[j] = roll(reversed data, 1)[j]."""
    rev = data.flip(0)
    return bwt_v3_payload(_remap256(rev, code_map), torch.roll(rev, 1), SENT_LARGE)


def a6_forward(data, config: str = "byte", impl: str = "symbol", device="cuda"):
    """a6 transform of ``data`` (bytes or a numpy uint8 array) on ``device``:
    (payload as a numpy uint8 array, base).

    Every prefix-free table dispatches to the n-symbol path through the
    codeword-order remap.  ``impl="bits"`` forces the literal bit-domain
    path, which also takes the single-symbol table with zero-length codes."""
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(bytes(data), np.uint8)
    if len(arr) == 0:
        return np.zeros(0, np.uint8), 0
    dev = as_device(device)
    codes = build_codes(arr, config)
    freq = np.bincount(arr, minlength=256)
    t = torch.from_numpy(np.array(arr, np.uint8)).to(dev)
    if impl == "symbol" and all(codes[i].length for i in range(256) if freq[i]):
        code_map = torch.from_numpy(_symbol_rank_map(codes)).to(dev)
        out, base = _a6_symbol_transform(t, code_map)
    else:
        vals, lens = _code_arrays(codes, dev)
        max_len = max((codes[i].length for i in range(256) if freq[i]), default=1)
        out, base = _a6_transform(t, vals, lens, max_len=max(int(max_len), 1))
    return out.cpu().numpy(), int(base)


# Extension-blob magic for order-remapped output.  Its u32-LE value
# 0xFF314F41 exceeds any valid base index (blocks are capped at 2^30), so a
# plain blob, which starts with the u32 base, never aliases it.
_ORDER_MAGIC = b"AO1\xff"


def a6_encode(data: bytes, config: str = "byte", order: str = "none", device="cuda") -> bytes:
    """a6-format blob (u32-LE base, then n payload bytes), byte-identical
    with ``archon_tpu.core.a6.a6_encode``.

    ``order`` other than "none" remaps the alphabet through the chosen
    heuristic (``entropy/order.py``) first and writes the extension format:
    the magic ``AO1\\xff``, the 256-byte destination table, the plain blob."""
    if order == "none":
        out, base = a6_forward(data, config, device=device)
        return np.uint32(base).tobytes() + out.tobytes()
    arr = np.frombuffer(bytes(data), np.uint8)
    dc = order_table(arr, order)
    inv = np.empty(256, np.uint8)
    inv[dc] = np.arange(256, dtype=np.uint8)
    out, base = a6_forward(inv[arr], config, device=device)
    return _ORDER_MAGIC + dc.tobytes() + np.uint32(base).tobytes() + out.tobytes()


def a6_decode(blob: bytes, config: str = "byte", order: str | None = None, device="cuda") -> bytes:
    """Invert an a6 blob.  Order-remapped blobs identify themselves by their
    magic; a stated ``order`` that the blob does not carry raises."""
    is_ordered = blob[:4] == _ORDER_MAGIC
    if order is not None and order != "none" and not is_ordered:
        raise ValueError(
            f"order={order!r} requested but the blob has no order table (plain a6 format)"
        )
    if is_ordered:
        dc = np.frombuffer(blob[4:260], np.uint8)
        inner = _a6_decode_raw(blob[260:], config, device)
        return dc[np.frombuffer(inner, np.uint8)].tobytes()
    return _a6_decode_raw(blob, config, device)


def _a6_decode_raw(blob: bytes, config: str = "byte", device="cuda") -> bytes:
    """Invert a plain a6 blob: byte/fix through the device inverse on
    ``device``; var through code-ordered buckets on the native host walk,
    or on ``device`` when the native library is missing."""
    base = int(np.frombuffer(blob[:4], np.uint32)[0])
    L = np.frombuffer(blob[4:], np.uint8)
    if len(L) == 0:
        return b""
    dev = as_device(device)
    if config in ("byte", "fix"):
        out = bwt_inverse(torch.from_numpy(L.copy()).to(dev), base, SENT_LARGE)
        return out.cpu().numpy().tobytes()
    # var: rebuild the Huffman table from the payload histogram (the BWT is a
    # permutation, so the frequencies are the input's) and walk with the
    # buckets in codeword order
    counts = np.bincount(L, minlength=256)
    codes = build_encoder_var(counts)
    keys = np.array(
        [(codes[c].code << (32 - codes[c].length)) if codes[c].length else -1 for c in range(256)],
        np.int64,
    )
    starts = np.zeros(256, np.int64)
    acc = 0
    for c in np.argsort(keys, kind="stable"):
        starts[c] = acc
        acc += int(counts[c])
    # without the library the walk runs on ``device`` rather than through
    # native.unbwt_starts' own fallback on the CPU
    if native.available():
        return native.unbwt_starts(L, base, starts).tobytes()
    out = bwt_inverse_with_starts(torch.from_numpy(L.copy()).to(dev), base, torch.from_numpy(starts))
    return out.cpu().numpy().tobytes()
