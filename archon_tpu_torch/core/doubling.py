"""Prefix-doubling suffix array construction (port of
``archon_tpu/core/doubling.py``), and the helpers every suffix sorter of the
port shares: sentinel conventions, rank inversion, head flags, the shifted
rank keys of a quadrupling round.

The re-expression of the reference's GPU prefix-doubling pipeline
(gpu/Archon.boo:94-119: init -> sort -> diff -> scan -> scatter -> jump *= 2)
with two corrections over the reference kernels:

- exact tie-breaking: the reference GPU sort compares packed 4-byte keys with
  a 1-step lookahead approximation (gpu/sh/k_sort.glv:10-19); here exact
  (rank, next-rank, ...) tuples are sorted, so no approximation error exists;
- explicit sentinel conventions: off-end reads compare as strictly smaller
  (a4 semantics, 'small') or strictly larger (a7 semantics, 'large') than any
  real symbol, which subsumes the anchor/LSC "defense" machinery of
  a4/direct.c and final/x2: doubling is repetition-immune by construction.

Work: O(n log n); each round is one multi-key sort (``ops.sort.sort_operands``,
the Hopper tile-sort and merge-level kernels on CUDA tensors), a head-flag
scan and a scatter.  The loop runs on the host and reads the count of
distinct ranks back once per round.
"""

from __future__ import annotations

import math

import torch

from ..ops.sort import sort_operands

SENT_SMALL = "small"  # off-end compares below every byte (a4)
SENT_LARGE = "large"  # off-end compares above every byte (a7)

# Extended-symbol space: real byte b -> b+1 in [1, 256]; the off-end pad is 0
# (small) or 511 (large).  Three extended symbols pack into 27 bits < int31.
_EXT_BASE = 512
_I32 = torch.int32


class _Counter:
    """Sorting rounds run and counts read back to the host since the last
    ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.rounds = 0
        self.host_syncs = 0


stats = _Counter()  # of the 1-D sorters: here, core/fast2, fast, sais_tpu and it2


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _invert_permutation(perm: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``values`` scattered to positions ``perm``.  The TPU version sorts by
    ``perm``; on the GPU the scatter ``out[perm] = values`` is one pass, and
    since ``perm`` is a permutation the result is identical."""
    out = torch.empty_like(values)
    out[perm] = values
    return out


def _scatter_drop(x: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of the 1-D ``x`` with ``out[tgt[j]] = vals[j]``; a target
    outside [0, n) is dropped (``x.at[tgt].set(vals, mode="drop")``): it goes
    into a spare last slot that is cut off, so no index faults on the device
    and no mask is compacted.  Targets in range must be distinct."""
    n = x.shape[0]
    wide = torch.cat([x, x.new_empty(1)])
    wide[torch.where((tgt >= 0) & (tgt < n), tgt, n)] = vals
    return wide[:n]


def rank_of(sa: torch.Tensor) -> torch.Tensor:
    """Inverse permutation of a suffix array (int32)."""
    return _invert_permutation(sa, _iota(sa.shape[0], sa.device))


def _heads(sorted_keys) -> torch.Tensor:
    """Group-head flags along the last axis: True where any key differs from
    its predecessor."""
    diff = sorted_keys[0][..., 1:] != sorted_keys[0][..., :-1]
    for k in sorted_keys[1:]:
        diff = diff | (k[..., 1:] != k[..., :-1])
    return torch.cat([diff.new_ones((*diff.shape[:-1], 1)), diff], dim=-1)


def _packed3(data: torch.Tensor, sentinel: str) -> torch.Tensor:
    """Order-3 key per position along the last axis: three extended symbols
    packed into one int32."""
    n = data.shape[-1]
    ext = data.to(_I32) + 1
    pad_val = 0 if sentinel == SENT_SMALL else _EXT_BASE - 1
    extp = torch.cat([ext, ext.new_full((*ext.shape[:-1], 2), pad_val)], dim=-1)
    return (extp[..., :n] * (_EXT_BASE * _EXT_BASE) + extp[..., 1 : n + 1] * _EXT_BASE
            + extp[..., 2 : n + 2])


def _dense_rank(keys: torch.Tensor):
    """Rank every element by value (dense, ties share a rank).

    Returns (rank, num_unique), the count a 0-d tensor.  One sort, a
    head-flag cumsum and the inversion."""
    iota = _iota(keys.shape[0], keys.device)
    sorted_keys, sorted_idx = sort_operands((keys,), (iota,))
    ranks_sorted = (torch.cumsum(_heads([sorted_keys]), 0) - 1).to(_I32)
    return _invert_permutation(sorted_idx, ranks_sorted), ranks_sorted[-1] + 1


def _initial_rank(data: torch.Tensor, sentinel: str):
    """Order-3 initial ranks: (rank, num_unique)."""
    return _dense_rank(_packed3(data, sentinel))


def _shifted_rank(padded: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """rank[i + k] along the last axis, the off-end sentinel past the end: a
    slice of the rank padded with n sentinels (contiguous, not a gather)."""
    s = min(k, n)
    return padded[..., s : s + n]


def _quad_keys(rank: torch.Tensor, k: int, sentinel: str):
    """The quadrupling round's keys (rank[p], rank[p+k], rank[p+2k],
    rank[p+3k]) along the last axis, off_end past the end."""
    n = rank.shape[-1]
    off_end = -1 if sentinel == SENT_SMALL else n + 1
    padded = torch.cat([rank, torch.full_like(rank, off_end)], dim=-1)
    return [rank, *(_shifted_rank(padded, n, j * k) for j in (1, 2, 3))]


def suffix_array(data: torch.Tensor, sentinel: str = SENT_SMALL, sort_fn=None) -> torch.Tensor:
    """Suffix array (int32) of a uint8 tensor under the sentinel convention,
    on the tensor's device.

    Quadrupling rounds: each sorts (rank, rank@k, rank@2k, rank@3k), so the
    context length multiplies by 4 per sort, until every rank is distinct.
    ``sort_fn(r0, r1, r2, r3, iota)`` replaces the sort of a round (it must be
    stable on the four keys); ``None`` means ``ops.sort.sort_operands``."""
    n = data.shape[0]
    if n <= 1:
        return torch.zeros(n, dtype=_I32, device=data.device)
    if sort_fn is None:
        def sort_fn(*ops):
            return sort_operands(ops[:4], ops[4:])

    iota = _iota(n, data.device)
    rank, nuniq = _initial_rank(data, sentinel)
    stats.rounds += 1
    stats.host_syncs += 1
    nuniq, k = int(nuniq), 3
    while nuniq < n and k < n:
        *ks, sorted_idx = sort_fn(*_quad_keys(rank, k, sentinel), iota)
        ranks_sorted = (torch.cumsum(_heads(ks), 0) - 1).to(_I32)
        rank = _invert_permutation(sorted_idx, ranks_sorted)
        stats.rounds += 1
        stats.host_syncs += 1
        nuniq, k = int(ranks_sorted[-1]) + 1, k * 4
    # rank is now a permutation: its inverse is the suffix array
    return _invert_permutation(rank, iota)


def num_doubling_rounds(n: int) -> int:
    """Upper bound on rounds executed for input length n (k: 3,6,12,... >= n)."""
    if n <= 3:
        return 1
    return 1 + math.ceil(math.log2(n / 3))
