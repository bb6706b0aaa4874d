"""Induced sorting re-expressed for data-parallel hardware (port of
``archon_tpu/core/sais_tpu.py``; the module keeps the JAX file's name).

This is the a7-parity path at the *algorithm* level (reference: SA-IS with
Yuta Mori optimizations, a7/src/archon.cpp:8-11): LMS reduction + recursion
+ induced derivation.  The sequential bucket-pointer sweeps of the reference
(`inducePre`/`inducePost`, archon.cpp:387-562) cannot run as written on a
vector machine, so each phase is re-derived as sorts and scans:

1. **Type classification** (findLMS analog, archon.cpp:160-172): S/L types
   are the first non-zero neighbor-comparison sign to the right of each
   position, read at the index a reversed running maximum finds.
2. **LMS substring naming** (reduce/reduceFast analog, archon.cpp:581-649):
   ranks of *cap-bounded* windows over the (char,type) alphabet, doubling
   the window each round.  Caps compose exactly (every position strictly
   inside an LMS gap shares the same next-LMS) and a per-position
   "terminal" value enters the key the moment the window crosses the cap,
   so equal LMS substrings (incl. their closing symbol) get equal ranks in
   ceil(log2 max-gap) rounds.  The (char,type) pairwise order equals true
   suffix order (L sorts before S within a bucket, the bucket-head/tail
   placement rule of the reference), verified against the golden oracle.
3. **Recursion with strategy switch** (solve/type-squeeze analog,
   archon.cpp:668-689,808-815): the named string (m <= (n+1)/2) solves on
   the doubling engine (``fast2.suffix_ranks_windows``), the counterpart of
   a7 switching representations on the reduced problem.
4. **Induced derivation** (inducePost analog, archon.cpp:518-562): the
   L-suffix order is the capped-window rank where the terminal carries the
   *exact* LMS suffix rank (every maximal L-run ends at an LMS position by
   definition); the S-suffix order symmetrically caps at the next L-type
   with the L-ranks as terminals.  Each is the same routine as naming with a
   different terminal seed: log2(max-gap) rounds instead of a sequential
   sweep.  A final 2-key sort over ((char,type), class-rank) interleaves
   the classes exactly as the reference's bucket scatter does.

Work: O(n log maxgap) + the reduced solve, against O(n log maxdepth) for
plain doubling.  Every ``_joint_rank`` is one 2-key sort of 2(n+1) elements
through ``ops.sort.sort_operands``; each ``_capped_ranks`` reads its largest
gap back once and loops on the host.

SENT_LARGE reduces to SENT_SMALL by complementing the text and reversing
the rank (a4 vs a7 convention duality; golden/sa.py documents both).
"""

from __future__ import annotations

import torch

from ..ops.scan import blocked_cummax
from ..ops.sort import sort_operands
from .doubling import (
    SENT_LARGE,
    SENT_SMALL,
    _I32,
    _heads,
    _invert_permutation,
    _iota,
    _scatter_drop,
    stats,
)
from .fast2 import suffix_ranks_windows

_BIG = 0x3FFFFFFF
_PAD = -1


def _joint_rank(a1, b1, a2, b2):
    """Dense joint rank of 2-key pairs from two aligned arrays.

    Ranks the multiset {(a1[i], b1[i])} + {(a2[i], b2[i])} so window values
    and terminal values live on one comparable scale; returns the two rank
    arrays.  One (2n)-element 2-key sort, a scan and the inversion."""
    n1 = a1.shape[0]
    idx = _iota(2 * n1, a1.device)
    A_s, B_s, idx_s = sort_operands((torch.cat([a1, a2]), torch.cat([b1, b2])), (idx,))
    slot = blocked_cummax(torch.where(_heads([A_s, B_s]), idx, 0))
    r = _invert_permutation(idx_s, slot)
    stats.rounds += 1
    return r[:n1], r[n1:]


def _capped_ranks(u, e, is_cap, ref):
    """Rank every position by its cap-bounded window.

    u: (n1,) int32 symbols; e[x]: cap position (the window covers
    [x, e[x]] inclusive, then pads); is_cap: positions that can serve as
    caps; ref: terminal refinement read at cap positions (the window's
    final key component is (u[cap], ref[cap]+1)).

    Equal windows (content + terminal) get equal ranks; distinct windows
    rank in true comparison order.  ceil(log2 max(e-x)) + 1 rounds."""
    n1 = u.shape[0]
    iota = _iota(n1, u.device)
    v, T = _joint_rank(u, torch.zeros_like(u), u, torch.where(is_cap, ref + 1, _BIG))
    stats.host_syncs += 1
    maxgap = int((e - iota).max())
    pad = torch.full_like(u, _PAD)
    e_safe = e.clamp(max=n1 - 1)
    h = 1
    while h <= maxgap:
        xph = iota + h
        b = torch.where(xph < e, v[xph.clamp(max=n1 - 1)], torch.where(xph == e, T[e_safe], _PAD))
        v, T = _joint_rank(v, b, T, pad)
        h *= 2
    return v


def _rev_cummin(vals: torch.Tensor) -> torch.Tensor:
    """Running minimum from the right (``lax.cummin(reverse=True)``): the
    blocked running maximum of the flipped, negated values."""
    return -blocked_cummax(-vals.flip(0)).flip(0)


def _next_pos(mask: torch.Tensor, n: int) -> torch.Tensor:
    """e[x] = smallest y > x with mask[y], else n."""
    vals = torch.where(mask, _iota(mask.shape[0], mask.device), n)
    return torch.cat([_rev_cummin(vals)[1:], vals.new_full((1,), n)])


def _types(d: torch.Tensor) -> torch.Tensor:
    """S/L types of the n+1 positions of ``d`` + [$] (True: S-type).  A
    position is S iff the first non-zero sign of s[y+1] - s[y], y >= x, is
    positive; the terminator compares below every char (sign -1 at n-1) and
    is itself S (+1 at n).  The nearest non-zero at or right of x is found
    by index (the running minimum from the right over the marked indices),
    and its sign gathered."""
    cmp = torch.cat([torch.sign(d[1:] - d[:-1]), d.new_tensor([-1, 1])])
    n1 = cmp.shape[0]
    marked = torch.where(cmp != 0, _iota(n1, d.device), n1 - 1)
    return cmp[_rev_cummin(marked)] > 0


def _sais_ranks_small(data: torch.Tensor) -> torch.Tensor:
    n = data.shape[0]
    n1 = n + 1  # data' = data + [$] (the terminator-smallest virtual char)
    dev = data.device
    d = data.to(_I32)

    t = _types(d)
    lms = torch.cat([t.new_zeros(1), t[1:] & ~t[:-1]])

    # (char,type) alphabet; sentinel symbol 1 below every real (u >= 2)
    u = torch.cat([d * 2 + t[:n].to(_I32) + 2, d.new_ones(1)])
    e_lms = _next_pos(lms, n)
    is_l = ~t
    e_l = _next_pos(is_l, n)

    # --- naming: equal LMS substrings share a rank (terminal ref = 0)
    v_name = _capped_ranks(u, e_lms, lms, torch.zeros_like(u))

    # --- reduce + solve on the doubling engine (static cap M); the sort is
    # stable, so the LMS positions come out in text order
    M = n1 // 2 + 1
    _, lpos, lname = sort_operands((torch.where(lms, 0, 1).to(_I32),), (_iota(n1, dev), v_name))
    keep = _iota(M, dev) < lms.sum()
    # names + 1 with constant-0 padding = small-sentinel semantics on the
    # reduced string (pad suffixes sort below all real ones; two real
    # suffixes can't enter the pad at the same offset)
    s1 = torch.where(keep, lname[:M] + 1, 0)
    r_star = suffix_ranks_windows(s1, 1, SENT_SMALL)
    ref = _scatter_drop(torch.zeros_like(u), torch.where(keep, lpos[:M], n1),
                        torch.where(keep, r_star, 0))

    # --- induce: L ranks (caps at LMS with exact LMS-suffix terminals),
    # then S ranks (caps at L with the L-rank terminals)
    v_l = _capped_ranks(u, e_lms, lms, ref)
    v_s = _capped_ranks(u, e_l, is_l, v_l)

    cls = torch.where(t[:n], v_s[:n], v_l[:n])
    iota = _iota(n, dev)
    _, _, order = sort_operands((u[:n], cls), (iota,))
    return _invert_permutation(order, iota)


def suffix_ranks_sais(data: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Rank array (inverse SA) of ``data`` (uint8) via induced sorting."""
    n = data.shape[0]
    if n <= 1:
        return torch.zeros(n, dtype=_I32, device=data.device)
    if sentinel == SENT_LARGE:
        # large-sentinel order = reversed small-sentinel order of the
        # complemented text
        return (n - 1) - _sais_ranks_small(255 - data)
    return _sais_ranks_small(data)


def suffix_array_sais(data: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Suffix array (int32) of ``data`` (uint8) via induced sorting."""
    rank = suffix_ranks_sais(data, sentinel)
    return _invert_permutation(rank, _iota(rank.shape[0], rank.device))


def bwt_sais(data: torch.Tensor, sentinel: str = SENT_SMALL):
    """Forward BWT via the induced-sorting path: (L, base), base an int."""
    if data.shape[0] <= 1:
        return data, 0
    rank = suffix_ranks_sais(data, sentinel)
    return _invert_permutation(rank, torch.roll(data, 1)), int(rank[0])
