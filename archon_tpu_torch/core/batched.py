"""Batched (block-parallel) forward BWT: B equal-length blocks as the rows
of one ``(B, n)`` tensor (port of ``archon_tpu/core/batched.py``; names and
structure kept).  The v3 family comes first, the v1 family (the 2-D
``core.fast``: ``suffix_ranks_batched``, ``bwt_forward_batched``,
``suffix_arrays_batched``) at the end.

Every row runs the pipeline of ``core/fast2.bwt_v3`` in lockstep: one
doubling schedule ``k = 12, 48, ...`` for the batch, every sort a
``ops.sort.sort_rows`` over all rows at once (on CUDA one launch of the tile
sort and one of each merge level for the whole batch).  A formula that is
the 1-D one along the last axis is the same function as in ``core/fast2``
(``_trigram_keys``, ``_packed3``, ``_quad_keys`` in place of ``_shifted2``,
``_group_ranks`` in place of ``_positional_ranks2`` and
``_actives_from_heads2``, ``_refine_in_groups``, ``_narrow_caps``); what differs here
is what has a row axis of its own: the sorts, the gathers and scatters, the
per-row counts.

What changed against the JAX source:

- ``lax.while_loop`` on ``jnp.max(na)`` and ``lax.cond`` become host control
  flow on the largest active count of the batch, read back once per round
  (``stats.host_syncs`` counts the reads, ``stats.rounds`` the sorting rounds);
  the batch pays its slowest row's rounds;
- the micro tail, which the JAX program runs whatever the counts are (a
  constraint of its compiler), is skipped when every row resolved inside the
  full rounds, and in ``v3`` when a row's residue exceeds its capacity: the
  results are the same;
- ``mode="drop"`` scatters go into a buffer one column wider than the row
  and the column is cut off (``_scatter_drop``);
- gathers and scatters along a row index the flattened tensor with int32
  row offsets, so no int64 index tensor of the batch's size is made.
"""

from __future__ import annotations

import torch

from ..ops.sort import sort_rows
from .doubling import SENT_SMALL, _Counter, _heads, _packed3
from .fast import _ranks_fused, _Stages
from .fast2 import (
    _BIG,
    _I32,
    _TILE,
    _group_ranks,
    _narrow_caps,
    _quad_keys,
    _refine_in_groups,
    _tie_members,
    _trigram_keys,
)

__all__ = [
    "bwt_batched_micro",
    "bwt_batched_micro_certified",
    "bwt_batched_v3",
    "bwt_batched_v3_certified",
    "bwt_forward_batched",
    "suffix_arrays_batched",
    "suffix_ranks_batched",
    "verify_bwt_batched",
]

_trigram_keys2 = _trigram_keys  # (B, n) -> (B, n + 9): the 1-D formula along the last axis


stats = _Counter()  # of the batched sorters of this module


def _max_count(na: torch.Tensor) -> int:
    """Largest per-row count of the batch, on the host (one sync)."""
    stats.host_syncs += 1
    return int(na.max())


def _row_iota(B: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device).expand(B, n)


def _row_offsets(B: int, stride: int, device) -> torch.Tensor:
    """(B, 1) int32 offsets of the rows of a flattened (B, stride) tensor."""
    if B * stride >= 1 << 31:
        raise ValueError("batch too large: B * (n + 1) must stay below 2^31")
    return torch.arange(B, dtype=_I32, device=device)[:, None] * stride


def _take_rows(arr2: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
    """``arr2[b, idx2[b, j]]`` (``jnp.take_along_axis(axis=1)``)."""
    B, n = arr2.shape
    return arr2.reshape(-1)[idx2 + _row_offsets(B, n, arr2.device)]


def _scatter_drop(x2: torch.Tensor, tgt: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A copy of ``x2`` with ``out[b, tgt[b, j]] = vals[b, j]``; a target
    outside [0, n) is dropped (``.at[rows, tgt].set(vals, mode="drop")``).
    Targets in range must be distinct within a row."""
    B, n = x2.shape
    wide = x2.new_empty((B, n + 1))
    wide[:, :n] = x2
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n)
    wide.view(-1)[tgt + _row_offsets(B, n + 1, x2.device)] = vals
    return wide[:, :n]


def _invert_rows(perm: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-row ``out[b, perm[b, j]] = values[b, j]`` for permutation rows: a
    scatter, as ``doubling._invert_permutation`` (the TPU version sorts)."""
    B, n = perm.shape
    out = torch.empty((B, n), dtype=values.dtype, device=values.device)
    out.view(-1)[perm + _row_offsets(B, n, perm.device)] = values
    return out


def _front(keep: torch.Tensor, apos: torch.Tensor, ar0: torch.Tensor):
    """Compacted (position, rank) pairs, padded past each row's count."""
    return torch.where(keep, apos, -1), torch.where(keep, ar0, _BIG)


def _sorted_round2(keys, prev2):
    """One batched round's sort with (iota, prev) riding along, and its
    epilogue: (sorted_idx, ranks_sorted, active flags, nactive, prev_sorted),
    nactive a (B,) tensor."""
    B, n = prev2.shape
    iota2 = _row_iota(B, n, prev2.device)
    *ks, sorted_idx, prev_s = sort_rows(keys, (iota2, prev2))
    ranks_sorted, active_s = _group_ranks(ks, iota2)
    stats.rounds += 1
    return sorted_idx, ranks_sorted, active_s, active_s.sum(dim=1, dtype=_I32), prev_s


def _bootstrap_sorted2(data2: torch.Tensor, prev2: torch.Tensor, sentinel: str):
    """Per-row context-12 bootstrap (4 packed-trigram keys, one sort), no
    rank inversion: the 2-D ``fast2._bootstrap_sorted``."""
    n = data2.shape[1]
    p27 = _trigram_keys2(data2, sentinel)
    return _sorted_round2([p27[:, 3 * j : 3 * j + n] for j in range(4)], prev2)


def _round_full_sorted2(si, rs, prev2, k: int, sentinel: str):
    """2-D full round with the deferred inversion at its top.  Also returns
    the context-k/4 rank snapshot it inverted (the micro tail's consistent
    coarse key array)."""
    rank = _invert_rows(si, rs)
    return (*_sorted_round2(_quad_keys(rank, k, sentinel), prev2), rank)


def _compact_from_round2(si, rs, active_s, cap: int):
    """Per-row active (position, rank) pairs from a round's own sorted
    order, front-compacted to ``cap``: one batched 1-key sort, stable, so the
    actives keep their order."""
    B = si.shape[0]
    key = torch.where(active_s, 0, 1).to(_I32)
    _, apos, ar0 = sort_rows((key,), (si, rs))
    keep = _row_iota(B, cap, si.device) < active_s.sum(dim=1, keepdim=True)
    return _front(keep, apos[:, :cap], ar0[:, :cap])


def _extract_actives_sorted2(si, rs, ac, na, cap: int):
    """Per-row entry-active (pos, r0) pairs when every row's na <= cap,
    without a full-width compaction sort: the 2-D
    ``fast2._extract_actives_sorted`` (32-wide tiles, tile-key sort, tile
    gather, cap*32-wide compaction)."""
    B, n = si.shape
    if n <= cap * _TILE:
        return _compact_from_round2(si, rs, ac, cap)
    T = -(-n // _TILE)
    pad = T * _TILE - n
    if pad:
        ac = torch.cat([ac, ac.new_zeros((B, pad))], dim=1)
        si = torch.cat([si, si.new_full((B, pad), -1)], dim=1)
        rs = torch.cat([rs, rs.new_full((B, pad), _BIG)], dim=1)
    ac3, si3, rs3 = (x.reshape(B * T, _TILE) for x in (ac, si, rs))
    tkey = (~ac3.any(dim=1)).to(_I32).view(B, T)
    _, tidx = sort_rows((tkey,), (_row_iota(B, T, si.device),))
    tidx = tidx[:, :cap] + _row_offsets(B, T, si.device)
    g_ac, g_si, g_rs = (x[tidx].reshape(B, -1) for x in (ac3, si3, rs3))
    key = torch.where(g_ac, 0, 1).to(_I32)
    _, apos, ar0 = sort_rows((key,), (torch.where(g_ac, g_si, -1), g_rs))
    keep = _row_iota(B, cap, si.device) < na[:, None]
    return _front(keep, apos[:, :cap], ar0[:, :cap])


def _shifted_keys(src2, safe, valid, steps, off_end):
    """``src2[b, safe + s]`` for each step s, ``off_end`` past the row's end
    and at invalid entries: the gathered keys of a narrowed round."""
    n = src2.shape[1]
    out = []
    for s in steps:
        p = safe + s
        out.append(torch.where(valid & (p < n), _take_rows(src2, p.clamp(max=n - 1)), off_end))
    return out


def _micro_round2(G, g: int, pos, r, j_lo: int, j_hi: int, sentinel: str):
    """Per-row inversion-free narrowed round: the 2-D ``fast2._micro_round``
    (sort on (r, G[p+j*g] for j in [j_lo, j_hi)) against the consistent
    coarse snapshot G; no compaction).  Returns (sorted positions, refined
    ranks, still-active counts per row)."""
    B, C = pos.shape
    off_end = -1 if sentinel == SENT_SMALL else _BIG
    valid = pos >= 0
    safe = torch.where(valid, pos, 0)
    keys = [torch.where(valid, r, _BIG)]
    keys += _shifted_keys(G, safe, valid, [j * g for j in range(j_lo, j_hi)], off_end)
    *ks, pos_s = sort_rows(keys, (torch.where(valid, pos, -1),))
    r_new, still, pad = _refine_in_groups(ks, pos_s, _row_iota(B, C, G.device))
    stats.rounds += 1
    return pos_s, torch.where(pad, _BIG, r_new), still.sum(dim=1, dtype=_I32)


def _round_active2c(rank, apos, ar0, k: int, sentinel: str):
    """Narrowed quadrupling round per row, carrying r0 (3 gathers a row)."""
    B, n = rank.shape
    C = apos.shape[1]
    iota_c = _row_iota(B, C, rank.device)
    off_end = -1 if sentinel == SENT_SMALL else n + 1
    valid = apos >= 0
    safe = torch.where(valid, apos, 0)
    keys = [torch.where(valid, ar0, _BIG)]
    keys += _shifted_keys(rank, safe, valid, [k, 2 * k, 3 * k], off_end)
    *ks, pos_s = sort_rows(keys, (torch.where(valid, apos, -1),))
    new_rank_s, still, pad = _refine_in_groups(ks, pos_s, iota_c)
    new_rank_s = torch.where(pad, 0, new_rank_s)
    rank = _scatter_drop(rank, torch.where(pad, n, pos_s), new_rank_s)

    key = torch.where(still, 0, 1).to(_I32)
    _, new_apos, new_ar0 = sort_rows((key,), (torch.where(still, pos_s, -1), new_rank_s))
    nactive = still.sum(dim=1, dtype=_I32)
    stats.rounds += 1
    return (rank, *_front(iota_c < nactive[:, None], new_apos, new_ar0), nactive)


def _narrow_cascade2(rank, k: int, na, apos, ar0, sentinel: str, caps):
    """2-D narrowing cascade at static capacities (``fast2._narrow_cascade``):
    rounds run at cap_i while the largest active count exceeds cap_{i+1}.
    Returns (k, rank, na)."""
    B, n = rank.shape
    m = _max_count(na)
    for i, cap in enumerate(caps):
        if m == 0 or k >= n:
            break
        if i > 0:
            keyc = torch.where(apos >= 0, 0, 1).to(_I32)
            _, aposc, ar0c = sort_rows((keyc,), (apos, ar0))
            keep = _row_iota(B, cap, rank.device) < na[:, None]
            apos, ar0 = _front(keep, aposc[:, :cap], ar0c[:, :cap])
        floor = caps[i + 1] if i + 1 < len(caps) else 0
        while m > floor and k < n:
            rank, apos, ar0, na = _round_active2c(rank, apos, ar0, k, sentinel)
            k *= 4
            m = _max_count(na)
    return k, rank, na


def _full_rounds(data2: torch.Tensor, sentinel: str):
    """Bootstrap and the full quadrupling rounds, run while the largest
    active count exceeds n/16: (k, si, rs, ac, na, prev_s, G, prev2, largest
    count).  G is the packed trigrams at bootstrap exit, the last inverted
    rank after full rounds."""
    n = data2.shape[1]
    prev2 = torch.roll(data2, 1, dims=1)
    si, rs, ac, na, prev_s = _bootstrap_sorted2(data2, prev2, sentinel)
    G = _trigram_keys2(data2, sentinel)[:, :n]
    k = 12
    m = _max_count(na)
    while m * 16 > n and m > 0 and k < n:
        si, rs, ac, na, prev_s, G = _round_full_sorted2(si, rs, prev2, k, sentinel)
        k *= 4
        m = _max_count(na)
    return k, si, rs, ac, na, prev_s, G, prev2, m


def _micro_tail(k: int, si, rs, ac, na, G, sentinel: str):
    """Tile extraction and the two inversion-free micro rounds: (sorted
    positions, refined ranks, still-active counts per row)."""
    cap3 = min(si.shape[1], 4096)
    apos_m, ar0_m = _extract_actives_sorted2(si, rs, ac, na, cap3)
    g = max(k // 4, 1)
    pos1, r1m, _ = _micro_round2(G, g, apos_m, ar0_m, 4, 16, sentinel)
    return _micro_round2(G, g, pos1, r1m, 16, 64, sentinel)


def _no_actives(si):
    """The micro tail's result for a batch with no active left: zero width."""
    empty = si.new_empty((si.shape[0], 0))
    return empty, empty


def _emit_micro2(prev2, si, rs, prev_s, pos, r):
    """Scatter-correct the carried payload at the refined actives; compute
    per-row base.  Valid only for rows whose ``resolved`` flag is True."""
    n = si.shape[1]
    valid = pos >= 0
    b_slot = (si == 0).to(torch.uint8).argmax(dim=1).to(_I32)
    base = _take_rows(rs, b_slot[:, None])[:, 0]
    if pos.shape[1] == 0:
        return prev_s, base
    safe = torch.where(valid, pos, 0)
    L = _scatter_drop(prev_s, torch.where(valid, r, n), _take_rows(prev2, safe))
    at0 = torch.where(valid & (pos == 0), r, -1).max(dim=1).values
    return L, torch.maximum(base, at0)


def _rank_micro2(si, rs, pos, r):
    """The final rank rows after the micro tail: resolved ranks never move
    (positional-rank invariant); only the refined actives' slots differ from
    the coarse inversion."""
    n = si.shape[1]
    rank = _invert_rows(si, rs)
    if pos.shape[1] == 0:
        return rank
    valid = pos >= 0
    return _scatter_drop(rank, torch.where(valid, pos, n), torch.where(valid, r, 0))


def _bwt_batched_v3_impl(data2: torch.Tensor, sentinel: str, want_rank: bool):
    """Shared v3 body: (L2, base2, rank2), rank2 the final full-width rank
    rows when ``want_rank`` and a (B, 0) placeholder otherwise."""
    B, n = data2.shape
    cap1, cap2, cap3 = _narrow_caps(n)
    k, si, rs, ac, na, prev_s, G, prev2, m = _full_rounds(data2, sentinel)

    micro_done = m == 0
    pos, r = _no_actives(si)
    if 0 < m <= cap3:
        pos, r, mna = _micro_tail(k, si, rs, ac, na, G, sentinel)
        micro_done = _max_count(mna) == 0
    if micro_done:
        L, base = _emit_micro2(prev2, si, rs, prev_s, pos, r)
        rank = _rank_micro2(si, rs, pos, r) if want_rank else si.new_zeros((B, 0))
        return L, base, rank

    # narrowed cascade; resolved suffixes' ranks never moved, so only the
    # entry actives' payload slots need correcting
    rank = _invert_rows(si, rs)
    apos0, ar0 = _compact_from_round2(si, rs, ac, cap1)
    k, rank, _ = _narrow_cascade2(rank, k, na, apos0, ar0, sentinel, (cap1, cap2, cap3))
    safe0 = torch.where(apos0 >= 0, apos0, 0)
    final_r = torch.where(apos0 >= 0, _take_rows(rank, safe0), n)
    L = _scatter_drop(prev_s, final_r, _take_rows(prev2, safe0))
    return L, rank[:, 0], (rank if want_rank else si.new_zeros((B, 0)))


def _micro_state(data2: torch.Tensor, sentinel: str):
    """Shared fast-path body: bootstrap -> full quadrupling rounds -> tile
    extraction -> two inversion-free micro rounds.  Returns everything the
    emitters need plus the per-row ``resolved`` mask (True iff that row's
    residue fit the micro tail and fully refined).  No narrowing cascade."""
    cap3 = min(data2.shape[1], 4096)
    k, si, rs, ac, na, prev_s, G, prev2, m = _full_rounds(data2, sentinel)
    if m == 0:
        return prev2, si, rs, prev_s, *_no_actives(si), torch.ones_like(na, dtype=torch.bool)
    mpos, mr, mna = _micro_tail(k, si, rs, ac, na, G, sentinel)
    # per row: the extraction is faithful only when that row's actives fit
    # cap3, and the row is done only when its own micro residue emptied
    return prev2, si, rs, prev_s, mpos, mr, (na <= cap3) & (mna == 0)


def _trivial(data2: torch.Tensor):
    B = data2.shape[0]
    return (data2, torch.zeros(B, dtype=_I32, device=data2.device),
            torch.ones(B, dtype=torch.bool, device=data2.device))


def bwt_batched_micro(data2: torch.Tensor, sentinel: str = SENT_SMALL):
    """Block-parallel forward BWT, fast path only: (L2, base2, resolved2),
    for ``data2`` a (B, n) uint8 tensor on the device to run on.

    The same steps as ``bwt_batched_v3`` up to the micro tail, without the
    narrowing cascade (needed only for residues of more than 4096 actives or
    deeper than 16k, which text does not produce).  Rows with
    ``resolved2[b] == False`` carry garbage in L2/base2 and must be
    recomputed by the caller (``io.blocks`` sends them through the 1-D
    cascade path)."""
    if data2.shape[1] <= 1:
        return _trivial(data2)
    prev2, si, rs, prev_s, pos, r, resolved = _micro_state(data2, sentinel)
    L, base = _emit_micro2(prev2, si, rs, prev_s, pos, r)
    return L, base, resolved


def bwt_batched_micro_certified(data2: torch.Tensor, sentinel: str = SENT_SMALL):
    """Fast path with the per-block LF certificate: (L2, base2, ok2,
    resolved2).  ok2 is meaningful only where resolved2."""
    if data2.shape[1] <= 1:
        L, base, ok = _trivial(data2)
        return L, base, ok, ok.clone()
    prev2, si, rs, prev_s, pos, r, resolved = _micro_state(data2, sentinel)
    L, base = _emit_micro2(prev2, si, rs, prev_s, pos, r)
    ok = verify_bwt_batched(data2, _rank_micro2(si, rs, pos, r), L, base, sentinel)
    return L, base, ok, resolved


def bwt_batched_v3(data2: torch.Tensor, sentinel: str = SENT_SMALL):
    """Block-parallel forward BWT, v3 structure: (L2, base2).

    Full rounds carry the previous-byte payload and defer rank inversion;
    when every block resolves inside the full-round loop L2 is the carried
    payload directly.  Small residues (<= 4096 actives in every block) take
    the inversion-free micro tail; only large or deeper residues pay the
    full-width narrowing cascade."""
    if data2.shape[1] <= 1:
        return _trivial(data2)[:2]
    L, base, _ = _bwt_batched_v3_impl(data2, sentinel, want_rank=False)
    return L, base


def bwt_batched_v3_certified(data2: torch.Tensor, sentinel: str = SENT_SMALL):
    """``bwt_batched_v3`` with the certificate: (L2, base2, ok2).  ok2[b]
    certifies block b in full: rank2 is a permutation whose sorted order
    lists suffixes in strictly increasing (char, next-suffix-rank) order, and
    L2/base2 agree with that rank array.  It costs one rank inversion and one
    certificate sort on top of the v3 pipeline."""
    if data2.shape[1] <= 1:
        return _trivial(data2)
    L, base, rank = _bwt_batched_v3_impl(data2, sentinel, want_rank=True)
    return L, base, verify_bwt_batched(data2, rank, L, base, sentinel)


def verify_bwt_batched(data2, rank2, L2, base2, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Per-row BWT certificate (the batched ``core.bwt.verify_sa``, fused
    with the emission check): True iff rank2 is the rank array of row data
    under the sentinel convention AND (L2, base2) is its BWT emission.

    One 1-key sort with three payloads does all the work: sorting by rank
    yields the SA order, where the first chars, successor ranks and previous
    bytes arrive as payloads."""
    B, n = data2.shape
    if n == 0:
        return torch.ones(B, dtype=torch.bool, device=data2.device)
    iota2 = _row_iota(B, n, data2.device)
    off = -1 if sentinel == SENT_SMALL else n + 1
    nxt = torch.where(iota2 + 1 < n, torch.roll(rank2, -1, dims=1), off)
    r_s, c_s, nxt_s, L_s = sort_rows(
        (rank2,), (data2.to(_I32), nxt, torch.roll(data2, 1, dims=1))
    )
    perm_ok = (r_s == iota2).all(dim=1)
    c_lt = c_s[:, :-1] < c_s[:, 1:]
    c_eq = c_s[:, :-1] == c_s[:, 1:]
    adj_ok = (c_lt | (c_eq & (nxt_s[:, :-1] < nxt_s[:, 1:]))).all(dim=1)
    return perm_ok & adj_ok & (L_s == L2).all(dim=1) & (base2 == rank2[:, 0])


# ---------------------------------------------------------------- v1 family


def _inverted_round2(keys):
    """One batched round that inverts its own ranks: sort ``keys`` with the
    index riding along, positional ranks, inversion: (rank, nactive), nactive
    a (B,) tensor.  The 2-D ``fast2._inverted_round``."""
    B, n = keys[0].shape
    iota2 = _row_iota(B, n, keys[0].device)
    *ks, sorted_idx = sort_rows(keys, (iota2,))
    ranks_sorted, active_s = _group_ranks(ks, iota2)
    stats.rounds += 1
    return _invert_rows(sorted_idx, ranks_sorted), active_s.sum(dim=1, dtype=_I32)


def _init2(data2: torch.Tensor, sentinel: str):
    """Order-3 positional ranks per row: (rank, nactive)."""
    return _inverted_round2([_packed3(data2, sentinel)])


def _round_full2(rank: torch.Tensor, k: int, sentinel: str):
    """One full-width quadrupling round per row: (new_rank, nactive)."""
    return _inverted_round2(_quad_keys(rank, k, sentinel))


def _compact2(rank: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-row active positions (non-singleton groups), -1-padded to cap."""
    B, n = rank.shape
    r_s, idx_s = sort_rows((rank,), (_row_iota(B, n, rank.device),))
    active = _tie_members(_heads([r_s]))
    _, pos = sort_rows((torch.where(active, 0, 1).to(_I32),), (idx_s,))
    keep = _row_iota(B, cap, rank.device) < active.sum(dim=1, keepdim=True)
    return torch.where(keep, pos[:, :cap], -1)


def _round_active2(rank: torch.Tensor, apos: torch.Tensor, k: int, sentinel: str):
    """Refine only the active positions per row (capacity C = apos.shape[1]):
    (rank, new_apos, nactive).  It is ``_round_active2c`` with the group-head
    rank read from ``rank`` instead of carried from the round before."""
    valid = apos >= 0
    ar0 = _take_rows(rank, torch.where(valid, apos, 0))
    rank, new_apos, _, nactive = _round_active2c(rank, apos, ar0, k, sentinel)
    return rank, new_apos, nactive


_STAGES2 = _Stages(_init2, _round_full2, _compact2, _round_active2, _max_count)


def suffix_ranks_batched(data2: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Rank arrays (inverse SAs) of every row of the (B, n) uint8 ``data2``.

    The schedule of ``core.fast._ranks_fused`` over this module's stages:
    full quadrupling rounds while more than 1/4 of any block's suffixes are
    tied, then narrowed rounds at capacity n/4 and n/32, with all blocks
    advancing in lockstep under one ``k``.  Blocks that finish early ride
    along idempotently (their rounds are no-ops by the positional-rank
    invariant)."""
    B, n = data2.shape
    if n <= 1:
        return torch.zeros((B, n), dtype=_I32, device=data2.device)
    return _ranks_fused(data2, sentinel, _STAGES2)


def bwt_forward_batched(data2: torch.Tensor, sentinel: str = SENT_SMALL):
    """Block-parallel forward BWT on the v1 sorter: (B, n) uint8 -> (L2,
    base2, rank2).

    L2[b, rank2[b, p]] = data2[b, (p-1) mod n]; base2[b] = rank2[b, 0].
    Rank-direct emission (no SA inversion, no random gather), per block: the
    batched ``core.bwt.bwt_forward_fast``."""
    rank = suffix_ranks_batched(data2, sentinel)
    if data2.shape[1] == 0:
        return data2, rank.new_zeros(data2.shape[0]), rank
    return _invert_rows(rank, torch.roll(data2, 1, dims=1)), rank[:, 0], rank


def suffix_arrays_batched(data2, sentinel: str = SENT_SMALL, device="cuda"):
    """Per-row suffix arrays of a (B, n) numpy uint8 array (or a tensor,
    which stays where it is), as a numpy int32 array: a host convenience
    that inverts the rank rows."""
    if not isinstance(data2, torch.Tensor):
        from ..io.blocks import as_byte_tensor

        data2 = as_byte_tensor(data2, device)
    rank = suffix_ranks_batched(data2, sentinel)
    B, n = rank.shape
    return _invert_rows(rank, _row_iota(B, n, rank.device)).cpu().numpy()
