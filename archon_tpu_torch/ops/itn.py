"""Itoh-Tanaka order-N machinery: descent masks, split statistics, and an
induced-derivation reference implementation.

This is the vectorized form of the reference's IT family:

- a4 sorts only "lucky" suffixes with ``fly[0] > fly[1] && fly[0] >= fly[-1]``
  (a4/src/archon.c:163-169, ~1/3 of N) and derives the rest with two waves
  (:172-194);
- a5 generalizes to order-4 masks built from streaming comparison bits
  (``fill_groups``, a5/src/archon.c:23-51) with a derivation cascade
  (``order_unlucky``, :53-103);
- the split-fraction study lives in a5/tool/estimate (results: order-3
  ~24% direct, order-4 ~12%, order-5 ~7%).

Vectorized, the masks are one comparison chain (`it_masks`), and the
measured fractions tell how much direct-sort work an induced path saves.
The induced waves themselves are rank-sequential (each placement depends on
already-placed smaller suffixes), i.e. a scan with data-dependent scatter —
`induced_derive_numpy` is the exact reference semantics used as the oracle
for ``core/it2``; the production sorter remains prefix doubling
(repetition-immune, fully parallel).

The port's own copy of ``archon_tpu/ops/itn.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def it_masks(data: np.ndarray, order: int = 4) -> np.ndarray:
    """Per-suffix descent mask of ``order`` bits (a5/src/archon.c:23-51).

    Bit j of mask[i] = (data[i+j] > data[i+j+1]) with off-end comparing as
    ascending — matching a5's streaming construction.  Vectorized: one
    shifted comparison per order bit.
    """
    n = len(data)
    d = data.astype(np.int16)
    ext = np.concatenate([d, np.full(order + 1, -1, np.int16)])
    mask = np.zeros(n, np.uint8)
    for j in range(order):
        gt = (ext[j : n + j] > ext[j + 1 : n + j + 1]).astype(np.uint8)
        mask |= gt << j
    return mask


def it2_lucky(data: np.ndarray) -> np.ndarray:
    """a4's IT-2 "lucky" predicate on positions x in 1..n (backward-key
    domain): direct-sort candidates satisfy in[x] > in[x+1] and
    in[x] >= in[x-1] in a4's forward scan (a4/src/archon.c:166)."""
    n = len(data)
    d = data.astype(np.int16)
    prev = np.concatenate([[int(d[0])], d[:-1]])
    nxt = np.concatenate([d[1:], [0x100 - 1]])
    return (d > nxt) & (d >= prev)


def estimate_masks(data: np.ndarray, order: int) -> np.ndarray:
    """Per-position sliding descent-window mask with the reference's exact
    semantics (a5/tool/estimate/estimate.c:56-66): bit = (a > c) where ``a``
    is the last symbol *different* from the previous one (run-skipping), and
    the window shifts MSB-first (mask = (mask*2 + bit) & (2^order - 1))."""
    n = len(data)
    d = np.asarray(data, np.uint8)
    masks = np.zeros(n, np.int32)
    a = b = 0xFF
    mask = 0
    lim = (1 << order) - 1
    for i in range(n):
        c = int(d[i])
        if c != b:
            a = b
        b = c
        mask = ((mask << 1) | (1 if a > c else 0)) & lim
        masks[i] = mask
    return masks


def split_fractions(data: np.ndarray, max_order: int = 5) -> dict[int, dict[str, float]]:
    """a5/tool/estimate analog: per IT order, the fraction of positions in
    the two directly-sorted descent bands (estimate.c:56-75; recorded
    results a5/tool/estimate/result/{3,4,5}.txt — e.g. order 3: groups
    001 + 110 = 24%).

    The bands generalize a5's order-4 direct-sort groups [0x2, 0x4) and
    [0xC, 0xE) (a5/src/archon.c:166-174): band A = [2^(o-3), 2^(o-2)),
    band B is its bitwise complement [2^o - 2^(o-2), 2^o - 2^(o-3)); for
    order 3 they degenerate to the singletons {001} and {110} the result
    files record.  Returns {order: {"band_a", "band_b", "lucky"}}."""
    out: dict[int, dict[str, float]] = {}
    n = len(data)
    if n == 0:
        return out
    for order in range(3, max_order + 1):
        masks = estimate_masks(data, order)
        lo_a, hi_a = 1 << max(order - 3, 0), 1 << (order - 2)
        lo_b, hi_b = (1 << order) - hi_a, (1 << order) - lo_a
        in_a = (masks >= lo_a) & (masks < hi_a)
        in_b = (masks >= lo_b) & (masks < hi_b)
        fa = float(in_a.mean())
        fb = float(in_b.mean())
        out[order] = {"band_a": fa, "band_b": fb, "lucky": fa + fb}
    return out


def itoh_tanaka_sa(data: np.ndarray) -> np.ndarray:
    """Itoh-Tanaka two-stage suffix array (terminator-smallest), numpy.

    The algorithmic heart of a4 re-expressed on forward suffixes: classify
    each suffix as descending-start type A (T[i] > T[i+1]; off-end counts as
    smaller) or type B; *directly sort only the B suffixes* (~1/2-2/3 of N;
    the reference reports ~1/3 lucky under its order-2 variant,
    final/x1/ArchonX1.c:6); place them at their bucket tails; then one
    left-to-right induction wave derives every A suffix from its successor
    (the structure of a4/src/archon.c:172-194).

    The wave is rank-sequential — each placement reads a possibly
    just-placed entry — which is exactly why the production device path uses
    prefix doubling instead, and why the a7 SA-IS induce passes are the
    "research-grade" item of SURVEY.md section 7.  This oracle nails the
    semantics for that future work and is tested against the golden SA.
    """
    n = len(data)
    if n == 0:
        return np.zeros(0, np.int64)
    d = data.astype(np.int16)
    nxt = np.concatenate([d[1:], [-1]])  # off-end smaller than everything
    type_a = d > nxt

    counts = np.bincount(data, minlength=256)
    heads = np.concatenate(([0], np.cumsum(counts)[:-1]))
    tails = np.cumsum(counts)

    # stage 1: direct sort of B suffixes (terminator-smallest comparisons)
    b_idx = np.nonzero(~type_a)[0]
    view = bytes(data)
    b_sorted = sorted(b_idx.tolist(), key=lambda i: view[i:])
    sa = np.full(n, -1, np.int64)
    fill = tails.copy()
    for i in reversed(b_sorted):
        fill[data[i]] -= 1
        sa[fill[data[i]]] = i

    # stage 2: one L2R wave places every A suffix at its bucket head
    free = heads.copy()
    # seed: the last suffix's predecessor chain starts at the virtual empty
    # suffix, i.e. suffix n-1 is induced first if it is type A
    if type_a[n - 1]:
        sa[free[data[n - 1]]] = n - 1
        free[data[n - 1]] += 1
    for t in range(n):
        j = sa[t] - 1
        if j >= 0 and type_a[j]:
            sa[free[data[j]]] = j
            free[data[j]] += 1
    return sa


def wave_counts(data: np.ndarray) -> dict[str, int]:
    """Bookkeeping used by the a4-style progress reports (genprint,
    a4/src/archon.c:103-106): how many suffixes each phase handles."""
    lucky = it2_lucky(data)
    n = len(data)
    direct = int(lucky.sum())
    return {"total": n, "direct": direct, "derived": n - direct}
