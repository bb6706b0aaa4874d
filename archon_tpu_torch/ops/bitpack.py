"""Vectorized bit-stream packing, the a6 coder's hot path (port of
``archon_tpu/ops/bitpack.py``).

A prefix sum of code lengths gives every codeword's start offset; each
codeword touches at most two 32-bit words, and the contributions are summed
into the words (bit-disjoint, so add equals or).  The arithmetic is int64
masked to 32 bits, because torch on the CPU has no uint32 shift or add:
the words come back as int64 tensors holding u32 values.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def pack_codes_sized(
    data: torch.Tensor,
    code_values: torch.Tensor,
    code_lengths: torch.Tensor,
    max_len: int,
):
    """Pack each symbol's code LSB-first at increasing bit offsets, into a
    word buffer sized by the table's true maximum code length ``max_len``.

    data: (n,) uint8 symbols; code_values: (256,) int64 holding u32 codes;
    code_lengths: (256,) int32.  Returns (words int64[W] of u32 values,
    ends int32[n], total_bits as a 0-d int32 tensor)."""
    n = data.shape[0]
    idx = data.long()
    lengths = code_lengths.to(torch.int64)[idx]
    codes = code_values.to(torch.int64)[idx]
    ends = torch.cumsum(lengths, 0)
    total = ends[-1] if n else ends.new_zeros(())
    starts = ends - lengths

    nwords = (n * max_len + 31) // 32 + 1
    w0 = starts >> 5
    sh = starts & 31
    c0 = (codes << sh) & _U32
    # (codes >> 1) >> (31 - sh) avoids the shift by 32 when sh == 0
    c1 = (codes >> 1) >> (31 - sh)
    words = torch.zeros(nwords, dtype=torch.int64, device=data.device)
    for target, part in ((w0, c0), (w0 + 1, c1)):
        # a target past the buffer is dropped: it adds 0 to the last word
        keep = target < nwords
        words.index_add_(0, target.clamp(max=nwords - 1), torch.where(keep, part, 0))
    return words, ends.to(torch.int32), total.to(torch.int32)


def pack_codes(data: torch.Tensor, code_values: torch.Tensor, code_lengths: torch.Tensor):
    """32-bit-capacity variant of :func:`pack_codes_sized` (any legal table)."""
    return pack_codes_sized(data, code_values, code_lengths, 32)


def words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """Expand u32 words into a uint8 0/1 array, LSB first within each word."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    return ((words.to(torch.int64)[:, None] >> shifts[None, :]) & 1).reshape(-1).to(torch.uint8)
