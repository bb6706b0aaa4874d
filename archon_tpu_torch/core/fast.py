"""Suffix array with active-set narrowing, the v1 sorter (port of
``archon_tpu/core/fast.py``; stage names kept).

Real corpora contain long repeats (quotes, boilerplate, the Gauntlet
pathological family), which force the doubling loop to large k even though
only a shrinking fraction of suffixes is still tied.  ``core.doubling.
suffix_array`` pays full-array cost every round; this module narrows each
refinement round to the *active* suffixes (members of non-singleton rank
groups), the analog of Larsson-Sadakane group refinement and the structural
answer to the reference's anchor/LSC "defense" machinery
(a4/src/direct.c:82-161): pathological repetitions cost O(active * log) here
instead of blowing up a comparison sort.

Key invariant: ranks are *positional*, rank[p] = sorted position of p's
group head, so refining a subset assigns globally consistent new ranks
(group head position + subgroup offset) without renumbering anything else.

Structure (``_ranks_fused``): init -> full rounds while more than 1/4 of the
suffixes are tied -> compaction to capacity n/4 and narrowed rounds while
more than 1/32 are tied -> compaction to n/32 and narrowed rounds to
completion.  The loops run on the host and read the active count back once
per round; every sort is ``ops.sort.sort_operands``.  The JAX module has each
stage twice, a body (``_init_body``, ...) and its jitted wrapper (``_init``,
...); nothing is traced here, so each stage is one function under the
wrapper's name.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.sort import sort_operands
from .doubling import (
    SENT_SMALL,
    _I32,
    _heads,
    _invert_permutation,
    _iota,
    _packed3,
    _scatter_drop,
)
from .fast2 import _BIG, _count, _inverted_round, _refine_in_groups, _round_full_c, _tie_members


def _init(data: torch.Tensor, sentinel: str):
    """Order-3 positional ranks: (rank, nactive)."""
    return _inverted_round([_packed3(data, sentinel)])[:2]


def _round_full(rank: torch.Tensor, k: int, sentinel: str):
    """One full-width quadrupling round: (new_rank, nactive)."""
    return _round_full_c(rank, k, sentinel)[:2]


def _compact(rank: torch.Tensor, cap: int) -> torch.Tensor:
    """Positions belonging to non-singleton groups, padded to cap with -1."""
    n = rank.shape[0]
    r_s, idx_s = sort_operands((rank,), (_iota(n, rank.device),))
    active = _tie_members(_heads([r_s]))
    # actives to the front (stable: they keep their rank order)
    _, pos = sort_operands((torch.where(active, 0, 1).to(_I32),), (idx_s,))
    return torch.where(_iota(cap, rank.device) < active.sum(), pos[:cap], -1)


def _round_active(rank: torch.Tensor, apos: torch.Tensor, k: int, sentinel: str):
    """Refine only the active positions (capacity C = apos.shape[0]):
    (rank, new_apos, nactive).  Pads carry position -1 and key 0x7FFFFFFF."""
    n = rank.shape[0]
    iota_c = _iota(apos.shape[0], rank.device)
    off_end = -1 if sentinel == SENT_SMALL else n + 1
    valid = apos >= 0
    safe = torch.where(valid, apos, 0)

    def shifted(j):
        p = safe + j * k
        return torch.where(valid & (p < n), rank[p.clamp(max=n - 1)], off_end)

    r0 = torch.where(valid, rank[safe], _BIG)
    *ks, pos_s = sort_operands((r0, shifted(1), shifted(2), shifted(3)),
                               (torch.where(valid, apos, -1),))
    new_rank_s, still, pad = _refine_in_groups(ks, pos_s, iota_c)
    rank = _scatter_drop(rank, torch.where(pad, n, pos_s), torch.where(pad, 0, new_rank_s))

    # compact the still-active positions to the front
    _, new_apos = sort_operands((torch.where(still, 0, 1).to(_I32),),
                                (torch.where(still, pos_s, -1),))
    nactive = _count(still)
    return rank, torch.where(iota_c < nactive, new_apos, -1), nactive


def _finish(rank: torch.Tensor) -> torch.Tensor:
    """The suffix array of a finished (permutation) rank array."""
    return _invert_permutation(rank, _iota(rank.shape[0], rank.device))


class _Stages(NamedTuple):
    """The stage functions of one sorter family and ``count``, which reads a
    stage's active count as a host int."""

    init: Callable
    round_full: Callable
    compact: Callable
    round_active: Callable
    count: Callable


# the 1-D family: its stages read their counts back themselves
_STAGES = _Stages(_init, _round_full, _compact, _round_active, int)


def _phase_full(rank, k: int, nactive: int, sentinel: str, stop_den: int, stages=_STAGES):
    """Full-size rounds until the active fraction drops to 1/stop_den (or
    done): (k, rank, nactive)."""
    n = rank.shape[-1]
    while nactive * stop_den > n and nactive > 0 and k < n:
        rank, na = stages.round_full(rank, k, sentinel)
        k, nactive = k * 4, stages.count(na)
    return k, rank, nactive


def _phase_active(rank, apos, k: int, nactive: int, sentinel: str, stop_den: int,
                  stages=_STAGES):
    """Narrowed rounds at the fixed capacity C = apos.shape[-1], until the
    active fraction drops to 1/stop_den (``stop_den`` 0: to completion):
    (k, rank, apos, nactive)."""
    n = rank.shape[-1]
    while (nactive * stop_den > n if stop_den else nactive > 0) and nactive > 0 and k < n:
        rank, apos, na = stages.round_active(rank, apos, k, sentinel)
        k, nactive = k * 4, stages.count(na)
    return k, rank, apos, nactive


def _ranks_fused(data: torch.Tensor, sentinel: str, stages=_STAGES) -> torch.Tensor:
    """The whole narrowed pipeline: the rank array of ``data`` (n >= 2), or
    with the batched family's ``stages`` the rank rows of a (B, n) batch, all
    rows advancing in lockstep under one ``k`` and the largest row's count."""
    n = data.shape[-1]
    rank, na = stages.init(data, sentinel)
    k, rank, nactive = _phase_full(rank, 3, stages.count(na), sentinel, 4, stages)
    cap1 = max(min(n, 4096), n // 4)
    cap2 = max(min(n, 4096), n // 32)
    for cap, stop_den in ((cap1, 32), (cap2, 0)):
        if nactive > 0 and k < n:
            k, rank, _, nactive = _phase_active(rank, stages.compact(rank, cap), k, nactive,
                                                sentinel, stop_den, stages)
    return rank


def suffix_ranks_fused(data: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Rank array (inverse suffix array) of ``data`` (uint8), int32: BWT
    emission only needs ranks (see ``core.bwt.bwt_forward_fast``)."""
    n = data.shape[0]
    if n <= 1:
        return torch.zeros(n, dtype=_I32, device=data.device)
    return _ranks_fused(data, sentinel)


def suffix_array_fused(data: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Narrowed suffix array of ``data`` (uint8), int32, on its device."""
    return _finish(suffix_ranks_fused(data, sentinel))


def suffix_array_fast(data, sentinel: str = SENT_SMALL, return_device: bool = False,
                      device="cuda"):
    """Narrowed suffix array of bytes, a numpy uint8 array or a tensor,
    computed on ``device`` (a tensor stays where it is).

    Semantically identical to ``core.doubling.suffix_array`` (golden-tested);
    structurally superior on repetition-heavy inputs where ties persist to
    large k.  ``return_device=True`` keeps the result a tensor on the device;
    otherwise it comes back as a numpy int32 array."""
    if not isinstance(data, torch.Tensor):
        from ..io.blocks import as_byte_tensor

        data = as_byte_tensor(data, device)
    sa = suffix_array_fused(data, sentinel)
    return sa if return_device else sa.cpu().numpy()
