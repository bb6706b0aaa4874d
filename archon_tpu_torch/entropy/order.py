"""Alphabet reordering heuristics (a6/src/order.c).

NOTE: in the committed reference these are configured via ``-o`` but never
invoked (main.c stores ``f_order`` and no call site exists; the one intended
call site is commented out in bwt_start_fixed, bwt.c:69-77), so they never
affect reference output.  Here they ARE wired: ``archon a6 -o <name>``
remaps the alphabet through the chosen heuristic before the a6 transform
(core/a6.py applies it; off by default).  Because the reference never
applies a reorder, any ``-o`` other than ``none`` is an extension format —
the blob carries the 256-byte destination table and is NOT byte-comparable
with the reference binary (the ``none`` default stays byte-exact).

All operate on the digram statistics matrix R2 built by ``order_init``
(order.c:34-44): R2[a][c] counts occurrences of symbol ``a`` whose most
recent *different* predecessor was ``c`` (runs collapsed).

The port's own copy of ``archon_tpu/entropy/order.py``.
"""

from __future__ import annotations

import numpy as np


def order_init(data: np.ndarray) -> np.ndarray:
    """Run-collapsed digram stats (order.c:34-44), vectorized.

    Scalar semantics (the reference loop): state ``b`` = previous symbol,
    ``c`` = most recent symbol different from ``b``, both starting at 0xFF;
    for each ``a``: if ``a != b`` then ``c, b = b, a``; R2[a][c] += 1.
    Every element of a run therefore contributes R2[run_sym][prev_run_sym],
    with the virtual pre-start run being 0xFF (a leading 0xFF run merges
    with it), which is what the run-length form below computes."""
    R2 = np.zeros((256, 256), np.int64)
    d = np.asarray(data, np.uint8)
    if len(d) == 0:
        return R2
    change = np.empty(len(d), bool)
    change[0] = True
    change[1:] = d[1:] != d[:-1]
    idx = np.nonzero(change)[0]
    runs = d[idx].astype(np.int64)
    counts = np.diff(np.append(idx, len(d)))
    prev = np.empty(len(runs), np.int64)
    prev[0] = 0xFF
    prev[1:] = runs[:-1]
    np.add.at(R2, (runs, prev), counts)
    return R2


def order_none(R2: np.ndarray, dc: np.ndarray) -> np.ndarray:
    return dc


def order_freq(R2: np.ndarray, dc: np.ndarray) -> np.ndarray:
    """Sort symbols by descending row sums (order.c:64-73)."""
    freq = R2.sum(axis=1)
    key = freq[dc]
    return dc[np.argsort(-key, kind="stable")]


def order_bubble(R2: np.ndarray, dc: np.ndarray) -> np.ndarray:
    """Freq sort, then pairwise swap relaxation (order.c:126-142)."""
    dc = order_freq(R2, dc).copy()
    nd = len(dc)
    while True:
        b0, b1 = -1, 0
        for i in range(nd - 1):
            c0, c1 = dc[i], dc[i + 1]
            cur = int(R2[c1][c0]) - int(R2[c0][c1])
            if cur > b1:
                b0, b1 = i, cur
        if b1 == 0:
            break
        dc[b0], dc[b0 + 1] = dc[b0 + 1], dc[b0]
    return dc


def order_greedy(R2: np.ndarray, dc: np.ndarray) -> np.ndarray:
    """In/out-degree greedy placement (order.c:145-190)."""
    dc = dc.copy()
    ins = R2.sum(axis=1).astype(np.int64)
    ots = R2.sum(axis=0).astype(np.int64)
    p0, p1 = 0, len(dc)
    while p0 != p1:
        best_pos, best_val = -1, 0
        for i in range(p0, p1):
            ch = dc[i]
            val = int(ots[ch] - ins[ch])
            if ins[ch] * ots[ch] == 0:
                best_pos = i
                break
            if best_pos < 0 or val > best_val:
                best_pos, best_val = i, val
        ch = dc[best_pos]
        if ots[ch]:
            p1 -= 1
            i = p1
        else:
            i = p0
            p0 += 1
        dc[best_pos] = dc[i]
        dc[i] = ch
        ins -= R2[:, ch]
        ots -= R2[ch, :]
    return dc


def order_topo(R2: np.ndarray, dc: np.ndarray) -> np.ndarray:
    """DFS topological order over freq-sorted destination lists
    (order.c:95-123); iterative DFS to avoid Python recursion limits."""
    nd = len(dc)
    dest = {}
    for ci in dc.tolist():
        key = R2[ci][dc]
        dest[ci] = dc[np.argsort(-key, kind="stable")].tolist()
    state = {}
    stack_out = []
    work = [(int(dc[0]), 0)]
    state[int(dc[0])] = 1
    while work:
        elem, j = work.pop()
        advanced = False
        lst = dest[elem]
        while j < len(lst):
            d = lst[j]
            j += 1
            if state.get(d, 0) == 0:
                work.append((elem, j))
                state[d] = 1
                work.append((d, 0))
                advanced = True
                break
        if not advanced:
            state[elem] = 2
            stack_out.append(elem)
    # reference writes post-order into stack slots bottom-up
    return np.array(stack_out[: nd], dtype=dc.dtype)


def order_table(data: np.ndarray, order: str) -> np.ndarray:
    """256-entry destination table ``dc`` for ``order`` on ``data``: slot i
    holds the symbol assigned new code i (the reference's dispatch shape,
    a6/src/main.c:33-41).  Always a permutation of 0..255."""
    if order not in ORDER_FUNCTIONS:
        raise ValueError(f"unknown order {order!r}")
    dc = np.arange(256, dtype=np.int64)
    if order != "none":
        dc = ORDER_FUNCTIONS[order](order_init(data), dc)
    return np.asarray(dc, np.uint8)


ORDER_FUNCTIONS = {
    "none": order_none,
    "freq": order_freq,
    "greedy": order_greedy,
    "topo": order_topo,
    "bubble": order_bubble,
    # 'matrix' (order.c:76-91) is flagged "not correct!" by the author and
    # dumps debug files; intentionally not ported (SURVEY.md "what NOT to port").
}
