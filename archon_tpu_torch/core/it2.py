"""Itoh-Tanaka reduced-volume BWT (port of ``archon_tpu/core/it2.py``).

The reference's core economy is sorting only a FRACTION of suffixes: a4
direct-sorts the ~1/3 "lucky" suffixes satisfying
``fly[0] > fly[1] && fly[0] >= fly[-1]`` (a4/src/archon.c:163-169) and
derives the other 2/3 with two sequential induction waves (:172-194);
a5's order-4 split gets direct volume to ~12%
(a5/tool/estimate/result/4.txt).  This module is that idea made exact on a
machine that sorts in parallel:

1. **Lucky classification** (vectorized a4 predicate): lucky positions are
   descent maxima, s[x] > s[x+1] and s[x] >= s[x-1].  Two lucky positions
   are never adjacent, and identical text windows have identical interior
   lucky structure (the predicate reads chars only).
2. **Phrase reduction**: the text factors into phrases [q_i, q_{i+1}]
   (lucky to next lucky, inclusive overlap: the LMS-substring shape of
   SA-IS, a7/src/archon.cpp:160-172, but at IT-2 lucky boundaries).  One
   n-wide multi-key sort names all phrases (packed char digits, see the
   lemma below); the reduced string of names (m ~ n/3) solves on the
   doubling engine (``fast2.suffix_ranks_windows``) with regular slices, no
   per-round gathers.
3. **One-sort induced merge**: every suffix x gets the key
   (chars s[x..e_x] padded, R*[e_x]) where e_x is the next lucky position
   and R* the reduced ranks: ONE n-wide sort interleaves derived and
   direct suffixes exactly, replacing the reference's two sequential waves.

**The exactness lemma** (why no SA-IS type alphabet is needed): suppose
suffixes x and y compare with equal chars through offset h-1 and h >= 1,
where x+h == e_x is x's lucky cap but y+h is strictly inside y's phrase
(hence non-lucky).  Matched chars at h-1 and h give s[y+h] >= s[y+h-1], so
non-luckiness of y+h forces s[y+h] <= s[y+h+1]; luckiness of x+h gives
s[x+h+1] < s[x+h] = s[y+h] <= s[y+h+1]: the comparison is decided
STRICTLY at offset h+1 with suffix(x) < suffix(y), REGARDLESS of either
continuation.  Past-cap key digits therefore encode "below every real
char" (digit 1 < char digits c+2) and the one-sort merge is exact; the
terminator (end of string, SENT_SMALL) takes digit 0, below both.  The
same argument makes phrase-name order consistent with extended-phrase
order, so the reduced-string suffix order equals the lucky-suffix order.

Deep phrases (length > the static window D) are handled exactly: naming
collisions among them invalidate the fast path (``ok=False``: the caller
falls back to ``bwt_v3``), while induce-stage ties fall into tie groups with
guaranteed common context D+1 chars and are refined by the standard
narrowed cascade (``fast2`` machinery); text never needs it, Gauntlet-class
periodicity falls back.

Both n-wide sorts are on 1 + K = 5 keys with two payloads (D = 11 packs
into K = 4 keys).  The sort kernels carry four keys in their tuples, so the
fifth (the merge's reduced rank) is read by index from device memory
wherever the first four tie.

SENT_LARGE reduces to SENT_SMALL by complementing the text and reversing
the output (the a4 vs a7 convention duality, as in core/sais_tpu.py).
"""

from __future__ import annotations

import os
import time

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
from .fast2 import (
    _BIG,
    _compact_from_round,
    _narrow_cascade,
    _narrow_caps,
    _tie_members,
    suffix_ranks_windows,
)
from .sais_tpu import _next_pos

_DIGIT_BASE = 260  # digits: 0 terminator < 1 past-cap < chars c+2 (2..257)


def _lucky_mask(d: torch.Tensor) -> torch.Tensor:
    """a4's IT-2 predicate, terminator-smallest: s[x] > s[x+1] (off-end
    char counts smaller, so n-1 qualifies on the descent test) and
    s[x] >= s[x-1] (vacuous at x=0).  Ref: a4/src/archon.c:166."""
    edge = d.new_full((1,), -1)
    return (d > torch.cat([d[1:], edge])) & (d >= torch.cat([edge, d[:-1]]))


def _phrase_keys(d32: torch.Tensor, dist: torch.Tensor, D: int):
    """K = (D+1)/3 packed int32 keys per position: slot j carries the char
    digit s[x+j]+2 while j <= dist[x] (content INCLUDING the cap char),
    the terminator digit 0 at the string end, and the past-cap digit 1
    beyond: the lemma's exact ordering."""
    n = d32.shape[0]
    assert (D + 1) % 3 == 0
    iota = _iota(n, d32.device)
    # char digits over the extended domain [0, n]: terminator digit 0
    ext = torch.cat([d32 + 2, d32.new_zeros(D + 1)])
    keys = []
    for k in range((D + 1) // 3):
        packed = torch.zeros_like(d32)
        for j in range(3 * k, 3 * k + 3):
            dig = torch.where((j <= dist) & (iota + j <= n), ext[j : j + n], 1)
            packed = packed * _DIGIT_BASE + dig
        keys.append(packed)
    return keys


def _it2_stage1(data: torch.Tensor, D: int, M: int):
    """Classify, name the phrases and build the reduced string: (keys, dist,
    s1, bad_name, overflow), ``keys`` the list of K phrase keys, ``s1`` the
    (M,) reduced string, the two flags 0-d bool tensors."""
    n = data.shape[0]
    d32 = data.to(_I32)
    iota = _iota(n, data.device)

    lucky = _lucky_mask(d32)
    # the next lucky position; position n, the terminator, is virtually
    # lucky and caps every tail phrase
    dist = _next_pos(lucky, n) - iota  # phrase length in chars (cap char at slot dist)
    keys = _phrase_keys(d32, dist, D)

    # --- phrase naming: one n-wide sort, lucky rows to the front
    flag = torch.where(lucky, 0, 1).to(_I32)
    flag_s, *key_s, pos_s, dist_s = sort_operands([flag, *keys], (iota, dist))
    head = _heads([flag_s, *key_s])
    names_s = blocked_cummax(torch.where(head, iota, 0))
    stats.rounds += 1
    # validity: equal truncated keys with both phrases deeper than D would
    # merge DISTINCT phrases into one name, unresolvable at this window
    bad_name = (~head & (dist_s > D) & (flag_s == 0)).any()

    # --- reduced string (names+1 in text order, 0-padded) at static M
    m = lucky.sum()
    lucky_row = flag_s[:M] == 0
    _, s1 = sort_operands((torch.where(lucky_row, pos_s[:M], _BIG),),
                          (torch.where(lucky_row, names_s[:M] + 1, 0),))
    s1 = torch.where(_iota(M, data.device) < m, s1, 0)
    return keys, dist, s1, bad_name, m > M


def _it2_merge(data: torch.Tensor, prev: torch.Tensor, keys, dist, r_star, D: int):
    """One-sort induced merge: (L_direct, base_direct, na, ranks_sorted,
    mpos_s, active_s), base and na 0-d tensors.  When na == 0 (every tie
    group resolved, the text-corpus common case) L_direct/base_direct ARE
    the answer; otherwise ``_it2_residual`` refines."""
    n = data.shape[0]
    iota = _iota(n, data.device)
    lucky = _lucky_mask(data.to(_I32))

    # --- propagate reduced ranks leftward: refnext[x] = r* of the first
    # lucky position > x.  Lucky positions are ordered, so that lucky's
    # 0-based index IS the inclusive-cumsum count c[x] of luckies <= x,
    # and the whole propagation is one cumsum + one monotone n-from-M
    # gather.  c[x] == m (no lucky to the right) maps to the terminator's
    # never-tied -1.
    M = r_star.shape[0]
    c = torch.cumsum(lucky, 0).to(_I32)
    refnext = torch.where(c < c[-1], r_star[c.clamp(max=M - 1)], -1)
    refkey = torch.where(dist <= D, refnext, _BIG)

    # --- one-sort induced merge: (phrase digits, reduced rank) + payload
    *mkeys_s, mpos_s, prev_s = sort_operands([*keys, refkey], (iota, prev))
    mhead = _heads(mkeys_s)
    ranks_sorted = blocked_cummax(torch.where(mhead, iota, 0))
    active_s = _tie_members(mhead)
    stats.rounds += 1
    base_direct = ranks_sorted[torch.argmax((mpos_s == 0).to(torch.uint8))]
    return prev_s, base_direct, active_s.sum(), ranks_sorted, mpos_s, active_s


def _it2_residual(prev, prev_s, ranks_sorted, mpos_s, active_s, na: int, D: int):
    """Residual refinement: tie groups (all with common context >= D+1
    chars by construction) refine through the standard narrowed cascade:
    (L, base), base an int."""
    n = prev.shape[0]
    caps = _narrow_caps(n)
    rank = _invert_permutation(mpos_s, ranks_sorted)
    apos0, ar0 = _compact_from_round(mpos_s, ranks_sorted, active_s, caps[0])
    _, rank, _ = _narrow_cascade(rank, D + 1, na, apos0, ar0, SENT_SMALL, caps)
    safe0 = apos0.clamp(min=0)
    final_r = torch.where(apos0 >= 0, rank[safe0], n)
    stats.host_syncs += 1
    return _scatter_drop(prev_s, final_r, prev[safe0]), int(rank[0])


def _reduced_capacity(n: int, red_frac: float = 0.45) -> int:
    """Static capacity M of the reduced string: a block whose lucky count
    exceeds it is flagged (overflow) and falls back."""
    return min(n, max(4096, 1 << (int(n * red_frac) - 1).bit_length()))


def _tick(label: str, x: torch.Tensor) -> None:
    """With ``ARCHON_IT2_DEBUG`` set: wait for the card to finish the stage
    that made ``x`` and print how long the wait took."""
    if os.environ.get("ARCHON_IT2_DEBUG"):
        t0 = time.time()
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        print(f"[it2-debug] {label}: forced in {time.time() - t0:.4f}s", flush=True)


def _it2_dispatch(data: torch.Tensor, prev: torch.Tensor, D: int, red_frac: float):
    """Enqueue the three stages (naming, reduced solve, merge) and return
    the device-side state ``_it2_finish`` resolves.  Nothing here reads the
    merge's result back; the reduced solve reads its active counts back
    round by round, as every rank pipeline of ``core.fast2`` does."""
    M = _reduced_capacity(data.shape[0], red_frac)
    keys, dist, s1, bad_name, overflow = _it2_stage1(data, D, M)
    _tick("stage1", s1)
    r_star = suffix_ranks_windows(s1, 1, SENT_SMALL)
    _tick("windows", r_star)
    L, base, na, ranks_sorted, mpos_s, active_s = _it2_merge(data, prev, keys, dist, r_star, D)
    _tick("merge", L)
    return L, base, na, ranks_sorted, mpos_s, active_s, bad_name | overflow


def _it2_finish(prev: torch.Tensor, state, D: int):
    """Resolve a dispatched it2 block: ONE read-back (the residue's size
    ``na``, the merge's base and the validity flag together) decides whether
    the rarely needed residual cascade runs.  The read lives HERE, not at
    dispatch time, so the streamed container enqueues a window of blocks
    before it waits for the oldest.  Returns (L, base, ok), base an int and
    ok a bool."""
    L, base, na, ranks_sorted, mpos_s, active_s, pre_bad = state
    stats.host_syncs += 1
    base, na, pre_bad = torch.stack([base, na.to(_I32), pre_bad.to(_I32)]).tolist()
    if na > 0:
        L, base = _it2_residual(prev, L, ranks_sorted, mpos_s, active_s, na, D)
        _tick("residual", L)
    return L, base, not pre_bad and na <= _narrow_caps(prev.shape[0])[0]


def bwt_it2_async(data: torch.Tensor, sentinel: str = SENT_SMALL, D: int = 11,
                  red_frac: float = 0.45):
    """Pipelined form of ``bwt_it2``: enqueues the stages and returns a
    zero-argument ``finish() -> (L, base, ok)``.  The streamed container
    dispatches a window of blocks through this before finishing the oldest."""
    n = data.shape[0]
    if n <= 1:
        return lambda: (data, 0, True)
    prev = torch.roll(data, 1)
    comp = sentinel == SENT_LARGE
    state = _it2_dispatch(255 - data if comp else data, prev, D, red_frac)

    def finish():
        L, b, ok = _it2_finish(prev, state, D)
        if comp:
            return L.flip(0), n - 1 - b, ok
        return L, b, ok

    return finish


def bwt_it2(data: torch.Tensor, sentinel: str = SENT_SMALL, D: int = 11,
            red_frac: float = 0.45):
    """Forward BWT of ``data`` (uint8, on the device to run on) via the IT-2
    reduced-volume structure: (L, base, ok).

    ``ok=False`` marks inputs the static window/reduction caps cannot name
    exactly (deep-phrase naming collisions, lucky fraction > red_frac, or
    an oversized induce residue); the caller must then fall back to
    ``bwt_v3``: the same candidate + exact-check + fallback discipline the
    streamed container applies per block."""
    return bwt_it2_async(data, sentinel, D, red_frac)()
