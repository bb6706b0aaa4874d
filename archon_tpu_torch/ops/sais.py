"""SA-IS: linear-time suffix array by induced sorting (numpy study).

The a7 generation's algorithm (a7/src/archon.cpp: findLMS :160-172,
inducePre :387-434, reduce :581-649, recursive solve :668-689, derive
:720-778, inducePost :518-562) re-expressed cleanly: classify L/S types,
bucket-scatter LMS suffixes, two induce sweeps, name LMS substrings, recurse
on the reduced string, induce the final array.  Linear work, and immune to
pathological repetitions by construction (the property the reference
advertises for a7; its *implementation* crashes on several input classes —
ours does not).

Terminator-smallest convention (suffix array of T with $ < everything),
i.e. golden.suffix_array(T, 'small').  This is the correctness model for
the data-parallel induced path ``core/sais_tpu`` (SURVEY.md section 7
hard-part 6: the induce sweeps are rank-sequential; published parallel
formulations use repeated bucket passes).  The production sorter remains
prefix doubling.

The port's own copy of ``archon_tpu/ops/sais.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def sais(T: np.ndarray) -> np.ndarray:
    """Suffix array of an integer array (values >= 0), terminator-smallest."""
    T = np.asarray(T)
    if len(T) == 0:
        return np.zeros(0, np.int64)
    return _sais(T.astype(np.int64), int(T.max()) + 1 if len(T) else 1)


def _types(T: np.ndarray) -> np.ndarray:
    """S-type mask: suffix i is S iff T[i..] < T[i+1..] (virtual $ is S)."""
    n = len(T)
    s = np.zeros(n, bool)
    # rightmost real suffix is L (its tail is the smaller $)
    for i in range(n - 2, -1, -1):
        s[i] = T[i] < T[i + 1] or (T[i] == T[i + 1] and s[i + 1])
    return s


def _lms_positions(s: np.ndarray) -> np.ndarray:
    n = len(s)
    prev_l = np.concatenate(([False], ~s[:-1]))
    return np.nonzero(s & prev_l)[0]


def _buckets(T: np.ndarray, K: int):
    counts = np.bincount(T, minlength=K)
    tails = np.cumsum(counts)
    heads = tails - counts
    return heads, tails


def _induce(T: np.ndarray, s: np.ndarray, K: int, lms_sorted: np.ndarray) -> np.ndarray:
    """Given LMS suffixes in sorted order, induce the full SA
    (the inducePre/inducePost sweep pair)."""
    n = len(T)
    heads, tails = _buckets(T, K)
    sa = np.full(n, -1, np.int64)
    # scatter LMS into bucket tails, in reverse sorted order
    t = tails.copy()
    for p in lms_sorted[::-1]:
        t[T[p]] -= 1
        sa[t[T[p]]] = p
    # L-sweep (left to right): the virtual $ induces suffix n-1 first
    h = heads.copy()
    if not s[n - 1]:
        sa_set = n - 1
        sa[h[T[n - 1]]] = n - 1
        h[T[n - 1]] += 1
    for i in range(n):
        j = sa[i] - 1
        if sa[i] > 0 and not s[j]:
            sa[h[T[j]]] = j
            h[T[j]] += 1
    # S-sweep (right to left) overwrites the provisional LMS placements
    t = tails.copy()
    for i in range(n - 1, -1, -1):
        j = sa[i] - 1
        if sa[i] > 0 and s[j]:
            t[T[j]] -= 1
            sa[t[T[j]]] = j
    return sa


def _sais(T: np.ndarray, K: int) -> np.ndarray:
    n = len(T)
    if n == 1:
        return np.zeros(1, np.int64)
    s = _types(T)
    lms = _lms_positions(s)
    if len(lms) == 0:
        # monotonically non-increasing text: suffixes sort by start position
        # reversed within equal prefixes — induction with no LMS seeds
        # (the exact class where the reference a7 segfaults)
        return _induce(T, s, K, np.zeros(0, np.int64))

    # 1st induce pass with unsorted LMS seeds sorts LMS *substrings*
    sa0 = _induce(T, s, K, lms)
    # name LMS substrings in sa0 order
    lms_set = np.zeros(n, bool)
    lms_set[lms] = True
    order0 = sa0[lms_set[sa0]]
    # substring end = next LMS position (or n)
    nxt_lms = np.full(n + 1, n, np.int64)
    for a, b in zip(lms[:-1], lms[1:]):
        nxt_lms[a] = b
    names = np.full(n, -1, np.int64)
    name = 0
    prev = -1
    for p in order0:
        if prev >= 0:
            la, lb = nxt_lms[prev] - prev, nxt_lms[p] - p
            if la != lb or not np.array_equal(
                T[prev : prev + la + 1], T[p : p + lb + 1]
            ):
                name += 1
        names[p] = name
        prev = p
    reduced = names[lms]

    if name + 1 < len(lms):
        order_r = _sais(reduced, name + 1)
        lms_sorted = lms[order_r]
    else:
        lms_sorted = np.zeros(len(lms), np.int64)
        lms_sorted[reduced] = lms

    return _induce(T, s, K, lms_sorted)
