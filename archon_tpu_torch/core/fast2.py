"""Suffix ranks and the forward BWT (port of ``archon_tpu/core/fast2.py``;
function names and structure are kept so each stage has its JAX namesake).

Two pipelines share the stages: the rank pipeline (``_ranks_loop``: a
bootstrap that inverts its ranks, full rounds that invert every round, the
narrowed cascade; ``suffix_ranks_windows`` seeds it with caller windows for
the a6 bit path) and ``bwt_v3`` (inversions deferred, the previous byte
carried through every sort).

Every ``lax.sort`` site becomes ``ops.sort.sort_operands``, a stable sort: on
CUDA tensors it runs the Hopper tile-sort and merge-level kernels.  The
``lax.while_loop`` / ``lax.cond`` control flow becomes Python loops and
branches on active counts read back with ``.item()`` -- one host sync per
round.  Scatters mask out-of-range targets explicitly (JAX's ``mode="drop"``
drops them; ``index_put_`` would fault).  Every key is int32.
"""

from __future__ import annotations

import torch

from ..ops.scan import blocked_cummax
from ..ops.sort import sort_operands
from .doubling import SENT_SMALL, _heads, _invert_permutation, _iota, _quad_keys, stats

_BIG = 0x7FFFFFFF
_EXT_BASE = 512
_TILE = 32
_I32 = torch.int32


def _sort_ctx(keys, iota, payloads):
    """Stable lexicographic sort by ``keys``; ``iota`` and ``payloads`` ride
    along (the sorted iota is the round's sorted order)."""
    return sort_operands(keys, (iota, *payloads))


def _tie_members(head: torch.Tensor) -> torch.Tensor:
    """Members of tie groups (groups of more than one), from the head flags."""
    nxt = torch.cat([head[..., 1:], head.new_ones((*head.shape[:-1], 1))], dim=-1)
    return ~(head & nxt)


def _group_ranks(sorted_keys, iota):
    """The per-round epilogue without its count, along the last axis:
    positional group ranks (cummax of head positions) and the active flags."""
    head = _heads(sorted_keys)
    return blocked_cummax(torch.where(head, iota, 0)), _tie_members(head)


def _epilogue(sorted_keys, iota):
    """Per-round epilogue: positional group ranks, active flags (members of
    tie groups), active count."""
    ranks_sorted, active_s = _group_ranks(sorted_keys, iota)
    return ranks_sorted, active_s, _count(active_s)


def _count(flags: torch.Tensor) -> int:
    """Set flags of one sorting round, read back to the host (the round's
    one sync; ``doubling.stats`` counts both)."""
    stats.rounds += 1
    stats.host_syncs += 1
    return int(flags.sum())


def _refine_in_groups(ks, pos_s, iota_c):
    """A narrowed round's rank update along the last axis: ``ks`` sorted,
    key 0 the rank before the round.  An element's new rank is its old one
    plus its new group's offset inside the old group.  Returns (new ranks,
    still-active flags, pad flags); ``pos_s < 0`` marks padding."""
    h0 = _heads(ks[:1])
    hF = _heads(ks)
    t0 = blocked_cummax(torch.where(h0, iota_c, 0))
    tF = blocked_cummax(torch.where(hF, iota_c, 0))
    pad = pos_s < 0
    return ks[0] + (tF - t0), _tie_members(hF) & ~pad, pad


def _trigram_keys(data: torch.Tensor, sentinel: str) -> torch.Tensor:
    """Packed-trigram key per position along the last axis (length n+9): an
    order-consistent context-3 key in the 9-bit extended-symbol space (byte
    b -> b+1, off-end pad 0 or 511)."""
    n = data.shape[-1]
    ext = data.to(_I32) + 1
    pad_val = 0 if sentinel == SENT_SMALL else _EXT_BASE - 1
    extp = torch.cat([ext, ext.new_full((*ext.shape[:-1], 11), pad_val)], dim=-1)
    return (
        extp[..., : n + 9] * (_EXT_BASE * _EXT_BASE)
        + extp[..., 1 : n + 10] * _EXT_BASE
        + extp[..., 2 : n + 11]
    )


def _bootstrap_round(data: torch.Tensor, sentinel: str):
    """Context-12 sort on four packed-trigram keys, with the rank inversion:
    (rank, nactive, sorted_idx, ranks_sorted, active flags)."""
    n = data.shape[0]
    p27 = _trigram_keys(data, sentinel)
    return _inverted_round([p27[3 * j : 3 * j + n] for j in range(4)])


def _inverted_round(keys):
    """Sort ``keys`` with the index riding along, then the epilogue and the
    rank inversion: (rank, nactive, sorted_idx, ranks_sorted, active flags)."""
    iota = _iota(keys[0].shape[0], keys[0].device)
    *ks, sorted_idx = _sort_ctx(keys, iota, ())
    ranks_sorted, active_s, nactive = _epilogue(ks, iota)
    return _invert_permutation(sorted_idx, ranks_sorted), nactive, sorted_idx, ranks_sorted, active_s


def _round_full_c(rank: torch.Tensor, k: int, sentinel: str):
    """Full-width quadrupling round that inverts its own ranks; also returns
    the round's sorted order and active flags for a following compaction:
    (new_rank, nactive, sorted_idx, ranks_sorted, active flags)."""
    return _inverted_round(_quad_keys(rank, k, sentinel))


def _ranks_loop(boot_state, k0: int, n: int, sentinel: str) -> torch.Tensor:
    """Shared back half of the rank pipelines: full rounds while actives >
    n/16, then the narrowed cascade.  ``boot_state`` is a bootstrap round's
    result; ``k0`` the context it already covers."""
    caps = _narrow_caps(n)
    rank, na, si, rs, ac = boot_state
    k = k0
    while na * 16 > n and na > 0 and k < n:
        rank, na, si, rs, ac = _round_full_c(rank, k, sentinel)
        k *= 4
    if na > 0 and k < n:
        apos, ar0 = _compact_from_round(si, rs, ac, caps[0])
        _, rank, _ = _narrow_cascade(rank, k, na, apos, ar0, sentinel, caps)
    return rank


def _ranks_impl(data: torch.Tensor, sentinel: str) -> torch.Tensor:
    return _ranks_loop(_bootstrap_round(data, sentinel), 12, data.shape[0], sentinel)


def _bootstrap_window_round(win: torch.Tensor, w: int, sentinel: str):
    """Bootstrap from caller-supplied window keys: ``win[x]`` is an
    order-consistent key for the ``w`` positions starting at x.  Four keys at
    offsets 0, w, 2w, 3w give context 4w in one sort."""
    m = win.shape[0]
    off = -1 if sentinel == SENT_SMALL else _BIG
    winp = torch.cat([win.to(_I32), torch.full((3 * w,), off, dtype=_I32, device=win.device)])
    return _inverted_round([winp[j * w : j * w + m] for j in range(4)])


def suffix_ranks_windows(win: torch.Tensor, w: int, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Rank array of the implicit string whose order-``w`` context keys are
    ``win`` (int32); reads past the end use the sentinel convention."""
    m = win.shape[0]
    if m <= 1:
        return torch.zeros(m, dtype=_I32, device=win.device)
    return _ranks_loop(_bootstrap_window_round(win, w, sentinel), 4 * w, m, sentinel)


def suffix_ranks_v2(data: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Rank array (inverse suffix array) of ``data`` (uint8)."""
    n = data.shape[0]
    if n <= 1:
        return torch.zeros(n, dtype=_I32, device=data.device)
    return _ranks_impl(data, sentinel)


def suffix_array_v2(data: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Suffix array of ``data`` (uint8), int32."""
    rank = suffix_ranks_v2(data, sentinel)
    return _invert_permutation(rank, _iota(rank.shape[0], rank.device))


def bwt_forward_v2(data: torch.Tensor, sentinel: str = SENT_SMALL):
    """Forward BWT through the rank pipeline and a 1-key emission sort with
    the previous byte as payload: (L, base, rank)."""
    rank = suffix_ranks_v2(data, sentinel)
    _, L = sort_operands((rank,), (torch.roll(data, 1),))
    return L, int(rank[0]) if rank.shape[0] else 0, rank


def suffix_array_fast2(data, sentinel: str = SENT_SMALL, device="cuda"):
    """Host convenience wrapper: bytes or a numpy uint8 array in, the suffix
    array as a numpy int32 array out, computed on ``device``."""
    from ..io.blocks import as_byte_tensor

    return suffix_array_v2(as_byte_tensor(data, device), sentinel).cpu().numpy()


def _bootstrap_sorted(data: torch.Tensor, prev: torch.Tensor, sentinel: str):
    """Context-12 sort on four packed-trigram keys, without the rank
    inversion: (sorted_idx, ranks_sorted, active flags, nactive, prev_sorted)."""
    n = data.shape[0]
    iota = _iota(n, data.device)
    p27 = _trigram_keys(data, sentinel)
    keys = [p27[3 * j : 3 * j + n] for j in range(4)]
    *ks, sorted_idx, prev_s = _sort_ctx(keys, iota, (prev,))
    ranks_sorted, active_s, nactive = _epilogue(ks, iota)
    return sorted_idx, ranks_sorted, active_s, nactive, prev_s


def _round_full_sorted(si, rs, prev, k: int, sentinel: str):
    """Full quadrupling round from the previous round's sorted-order state:
    the deferred rank inversion at its top, then the 4-key sort carrying
    (iota, prev).  Also returns the inverted (context k/4) rank, the
    snapshot the micro tail refines against."""
    iota = _iota(si.shape[0], si.device)
    rank = _invert_permutation(si, rs)
    *ks, sorted_idx, prev_s = _sort_ctx(_quad_keys(rank, k, sentinel), iota, (prev,))
    ranks_sorted, active_s, nactive = _epilogue(ks, iota)
    return sorted_idx, ranks_sorted, active_s, nactive, prev_s, rank


def _compact_from_round(sorted_idx, ranks_sorted, active_s, cap: int):
    """Active (position, group-head-rank) pairs from a round's sorted order,
    front-compacted to ``cap`` (-1 / _BIG beyond the active count)."""
    key = torch.where(active_s, 0, 1).to(_I32)
    _, apos, ar0 = sort_operands((key,), (sorted_idx, ranks_sorted))
    keep = _iota(cap, sorted_idx.device) < active_s.sum()
    return torch.where(keep, apos[:cap], -1), torch.where(keep, ar0[:cap], _BIG)


def _round_active_c(rank, apos, ar0, k: int, sentinel: str):
    """Narrowed quadrupling round over C actives, carrying r0 (3 gathers).
    Updates ``rank`` in place at the refined positions (the JAX version
    returns an updated copy) and returns it with the re-compacted actives."""
    n = rank.shape[0]
    C = apos.shape[0]
    iota_c = _iota(C, rank.device)
    off_end = -1 if sentinel == SENT_SMALL else n + 1
    valid = apos >= 0
    safe = torch.where(valid, apos, 0)

    def shifted(j):
        p = safe + j * k
        return torch.where(valid & (p < n), rank[p.clamp(max=n - 1)], off_end)

    r0 = torch.where(valid, ar0, _BIG)
    pos_key = torch.where(valid, apos, -1)
    r0_s, r1_s, r2_s, r3_s, pos_s = sort_operands(
        (r0, shifted(1), shifted(2), shifted(3)), (pos_key,)
    )
    new_rank_s, still, pad = _refine_in_groups([r0_s, r1_s, r2_s, r3_s], pos_s, iota_c)
    new_rank_s = torch.where(pad, 0, new_rank_s)
    rank[pos_s[~pad]] = new_rank_s[~pad]

    # compact still-active (pos, r0) to the front for the next round
    key = torch.where(still, 0, 1).to(_I32)
    _, new_apos, new_ar0 = sort_operands(
        (key,), (torch.where(still, pos_s, -1), new_rank_s)
    )
    nactive = _count(still)
    keep = iota_c < nactive
    return (
        rank,
        torch.where(keep, new_apos, -1),
        torch.where(keep, new_ar0, _BIG),
        nactive,
    )


def _narrow_caps(n: int):
    cap1 = max(min(n, 4096), n // 16)
    cap2 = max(min(n, 4096), n // 256)
    cap3 = min(n, 4096)
    return cap1, cap2, cap3


def _recompact(apos, ar0, na: int, cap_to: int):
    """Re-compact an active set to a smaller capacity (C-width sort)."""
    keyc = torch.where(apos >= 0, 0, 1).to(_I32)
    _, aposc, ar0c = sort_operands((keyc,), (apos, ar0))
    keep = _iota(cap_to, apos.device) < na
    return torch.where(keep, aposc[:cap_to], -1), torch.where(keep, ar0c[:cap_to], _BIG)


def _narrow_cascade(rank, k: int, na: int, apos, ar0, sentinel: str, caps):
    """Narrowed rounds at progressively smaller capacities: rounds run at
    cap_i while the active count exceeds cap_{i+1} (to completion at the
    last), re-compacting between stages.  Returns (k, rank, na)."""
    n = rank.shape[0]
    for i, cap in enumerate(caps):
        if na == 0 or k >= n:
            break
        if i > 0:
            apos, ar0 = _recompact(apos, ar0, na, cap)
        floor = caps[i + 1] if i + 1 < len(caps) else 0
        while na > floor and k < n:
            rank, apos, ar0, na = _round_active_c(rank, apos, ar0, k, sentinel)
            k *= 4
    return k, rank, na


def _extract_actives_sorted(si, rs, ac, na: int, cap: int):
    """Entry-active (position, group-head-rank) pairs when ``na <= cap``,
    without a full-width compaction sort: reduce 32-wide tiles of the
    round's sorted order, sort only the n/32 tile keys, gather the first
    ``cap`` candidate tiles and compact at cap*32 width."""
    n = si.shape[0]
    if n <= cap * _TILE:
        return _compact_from_round(si, rs, ac, cap)
    T = -(-n // _TILE)
    pad = T * _TILE - n
    if pad:
        ac = torch.cat([ac, ac.new_zeros(pad)])
        si = torch.cat([si, si.new_full((pad,), -1)])
        rs = torch.cat([rs, rs.new_full((pad,), _BIG)])
    ac2, si2, rs2 = (x.reshape(T, _TILE) for x in (ac, si, rs))
    tkey = (~ac2.any(dim=1)).to(_I32)
    _, tidx = sort_operands((tkey,), (_iota(T, si.device),))
    tidx = tidx[:cap]
    g_ac = ac2[tidx].reshape(-1)
    g_si = si2[tidx].reshape(-1)
    g_rs = rs2[tidx].reshape(-1)
    key = torch.where(g_ac, 0, 1).to(_I32)
    _, apos, ar0 = sort_operands((key,), (torch.where(g_ac, g_si, -1), g_rs))
    keep = _iota(cap, si.device) < na
    return torch.where(keep, apos[:cap], -1), torch.where(keep, ar0[:cap], _BIG)


def _micro_round(G, g: int, pos, r, j_lo: int, j_hi: int, sentinel: str):
    """Inversion-free narrowed round over C actives: refines ranks ``r``
    (context j_lo*g) to context j_hi*g by sorting on (r, G[p+j_lo*g], ...,
    G[p+(j_hi-1)*g]) against the one consistent snapshot ``G``.  Returns
    (sorted positions, refined ranks, still-active count)."""
    n = G.shape[0]
    C = pos.shape[0]
    iota_c = _iota(C, G.device)
    off_end = -1 if sentinel == SENT_SMALL else _BIG
    valid = pos >= 0
    safe = torch.where(valid, pos, 0)
    keys = [torch.where(valid, r, _BIG)]
    for j in range(j_lo, j_hi):
        p = safe + j * g
        keys.append(torch.where(valid & (p < n), G[p.clamp(max=n - 1)], off_end))
    *ks, pos_s = sort_operands(keys, (torch.where(valid, pos, -1),))
    r_new, still, pad = _refine_in_groups(ks, pos_s, iota_c)
    return pos_s, torch.where(pad, _BIG, r_new), _count(still)


def bwt_v3(data: torch.Tensor, sentinel: str = SENT_SMALL):
    """Forward BWT of ``data`` (uint8, on the device to run on): returns
    (L, base) with L a uint8 tensor on the same device and base an int.

    Bootstrap (context 12) -> full rounds with the rank inversion deferred
    to the top of the next round and the previous byte riding every sort.
    When the text resolves inside the full rounds, L is the carried payload.
    Otherwise a residue of <= 4096 actives takes the inversion-free micro
    tail, and larger or deeper residues the narrowed cascade."""
    if data.shape[0] <= 1:
        return data, 0
    return _bwt_v3_impl(data, torch.roll(data, 1), sentinel)


def bwt_v3_payload(data: torch.Tensor, payload: torch.Tensor, sentinel: str = SENT_SMALL):
    """``bwt_v3`` with a caller-supplied carried payload: L[rank[p]] =
    payload[p]; ``bwt_v3`` is the case payload = roll(data, 1)."""
    if data.shape[0] <= 1:
        return payload, 0
    return _bwt_v3_impl(data, payload, sentinel)


def _scatter_fix(L, pos, ranks, prev):
    """L[ranks] = prev[pos] at the valid (pos >= 0) entries."""
    L = L.clone()
    valid = pos >= 0
    L[ranks[valid]] = prev[pos[valid]]
    return L


def _bwt_v3_impl(data: torch.Tensor, prev: torch.Tensor, sentinel: str):
    n = data.shape[0]
    cap1, cap2, cap3 = _narrow_caps(n)

    si, rs, ac, na, prev_s = _bootstrap_sorted(data, prev, sentinel)
    # G: position-indexed granule-(k/4) consistent keys -- the packed
    # trigrams at bootstrap exit, the last inverted rank after full rounds.
    G = _trigram_keys(data, sentinel)[:n]
    k = 12
    while na * 16 > n and na > 0 and k < n:
        si, rs, ac, na, prev_s, G = _round_full_sorted(si, rs, prev, k, sentinel)
        k *= 4

    b_slot = torch.argmax((si == 0).to(_I32))
    if na == 0:  # resolved inside the full rounds
        return prev_s, int(rs[b_slot])

    if na <= cap3:  # micro tail: no full-width sort, no inversion
        apos_m, ar0_m = _extract_actives_sorted(si, rs, ac, na, cap3)
        g = max(k // 4, 1)
        pos1, r1m, _ = _micro_round(G, g, apos_m, ar0_m, 4, 16, sentinel)
        mpos, mr, mna = _micro_round(G, g, pos1, r1m, 16, 64, sentinel)
        if mna == 0:
            L = _scatter_fix(prev_s, mpos, mr, prev)
            at0 = torch.where((mpos == 0), mr, -1).max()
            return L, max(int(rs[b_slot]), int(at0))

    # narrowed cascade; resolved suffixes' ranks never moved, so only the
    # entry actives' payload slots need correcting
    rank = _invert_permutation(si, rs)
    apos0, ar0 = _compact_from_round(si, rs, ac, cap1)
    k, rank, _ = _narrow_cascade(rank, k, na, apos0, ar0, sentinel, (cap1, cap2, cap3))
    final_r = rank[apos0.clamp(min=0)]
    return _scatter_fix(prev_s, apos0, final_r, prev), int(rank[0])
