"""Offline research instruments (ports of the reference's tool/ tree).

These fed design constants back into the reference's core (SURVEY.md
section 2.2); the ports keep that feedback loop available:

- ``estimate_it_groups``   <- a5/tool/estimate/estimate.c:11-83
- ``huffman_bits_per_sym`` <- a6/tool/compress/compress.c:59-99
- ``reorder_direct_volume``<- a6/tool/reorder/reorder.c:346-359 (the IT
  variant estimators: what fraction each split strategy sorts directly)
- ``radix_direction_bench``<- tool/radix_dir/radix.c:38-87 (scan-direction
  microbenchmark on the host, numpy)
- ``route_search``         <- a5/tool/route/route.cpp (derivation-plan
  search over IT-N group dependencies, simplified exhaustive form)

The port's own copy of ``archon_tpu/utils/tools.py`` (numpy only), except
``memory_report``, which counts the port's own tensors.
"""

from __future__ import annotations

import time

import numpy as np

from ..entropy.huffman import build_encoder_var
from ..ops.itn import it_masks


def estimate_it_groups(data: np.ndarray, order: int = 3) -> dict[int, float]:
    """Frequency of each IT descent-mask group (a5/tool/estimate)."""
    mask = it_masks(np.asarray(data, np.uint8), order)
    counts = np.bincount(mask, minlength=1 << order)
    return {g: float(c) / max(len(data), 1) for g, c in enumerate(counts)}


def huffman_bits_per_sym(data: np.ndarray) -> float:
    """Exact-Huffman compression estimate (a6/tool/compress)."""
    data = np.asarray(data, np.uint8)
    freq = np.bincount(data, minlength=256)
    codes = build_encoder_var(freq)
    total = sum(int(freq[i]) * codes[i].length for i in range(256))
    return total / max(len(data), 1)


def _complexity(x) -> np.ndarray:
    """x * floor(log2 x), elementwise, 0 for x <= 1 inputs' log (reorder.c:13-17)."""
    x = np.asarray(x, np.int64)
    lg = np.zeros_like(x)
    nz = x > 1
    lg[nz] = np.floor(np.log2(x[nz])).astype(np.int64)
    return x * lg


def _fit1(d):
    """IT-1 (reorder.c fit1): digrams with a >= b, grouped by a."""
    r = np.zeros(256, np.int64)
    m = d[:-1] >= d[1:]
    np.add.at(r, d[:-1][m], 1)
    return r


def _fit2(d):
    """IT-2 (fit2): trigrams with a >= b < c, grouped by (a, b)."""
    r = np.zeros(1 << 16, np.int64)
    m = (d[:-2] >= d[1:-1]) & (d[2:] > d[1:-1])
    np.add.at(r, (d[:-2].astype(np.int64) << 8) + d[1:-1], m.astype(np.int64))
    return r


def _digrams(d):
    r = np.zeros((256, 256), np.int64)
    np.add.at(r, (d[:-1], d[1:]), 1)
    return r


def _fit1x(d):
    """IT-1x (fit1x): repeatedly sort the smallest remaining symbol group B
    directly, then mark every AB digram as derivable."""
    ra = np.bincount(d, minlength=256).astype(np.int64)
    rb = _digrams(d)
    groups = []
    big = np.int64(1 << 60)
    while True:
        cand = np.where(ra > 0, ra, big)
        mn = int(cand.argmin())
        if ra[mn] <= 0:
            break
        ra[mn] = 0
        groups.extend(rb[mn, :].tolist())
        rb[mn, :] = 0
        ra -= np.where(ra > 0, rb[:, mn], 0)
        rb[:, mn] = 0
    return np.array(groups, np.int64)


def _fit1y(d):
    """IT-1y (fit1y): greedily pick the symbol with the best
    benefit/complexity score (integer-divided, <<4 scaled as the ref does)."""
    rx = _digrams(d)
    groups = []
    while True:
        ncomp = 1 + _complexity(rx).sum(axis=1)
        nbene = rx.sum(axis=0)
        cv = (nbene << 4) // ncomp
        ms = int(cv.argmax())
        if cv[ms] <= 0:
            break
        groups.extend(rx[ms, :].tolist())
        rx[ms, :] = 0
        rx[:, ms] = 0
    return np.array(groups, np.int64)


def _fit12x(d):
    """IT-12x (fit12x): smallest remaining digram group BC sorted directly;
    ABC trigrams then derive the A-side digrams."""
    r = _digrams(d).reshape(-1)
    rx = np.zeros((256, 1 << 16), np.int32)  # int-sized like the reference's
    if len(d) >= 3:
        tri = (
            (d[:-2].astype(np.int64) << 16)
            + (d[1:-1].astype(np.int64) << 8)
            + d[2:]
        )
        np.add.at(rx.reshape(-1), tri, 1)
    r = np.where(r == 0, -1, r)
    groups = []
    big = np.int64(1 << 60)
    while True:
        cand = np.where(r >= 0, r, big)
        mn = int(cand.argmin())
        if r[mn] < 0:
            break
        groups.append(int(r[mn]))
        r[mn] = -1
        col = (np.arange(256, dtype=np.int64) << 8) + (mn >> 8)
        dec = rx[:, mn]
        r[col] = np.where(r[col] > 0, r[col] - dec, r[col])
        # (the reference asserts non-negativity here, archon reorder.c:175)
    return np.array(groups, np.int64)


def _fit2x1(d):
    """IT-2x1 (fit2x1): derive a symbol order by greedy min-row-sum digram
    elimination, then run the IT-2 predicate under that order."""
    r = _digrams(d)
    order = np.full(256, 0xFF, np.int64)
    order[d[:-1]] = 0
    work = r.copy()
    c = 0
    while True:
        rows = work.sum(axis=1)
        mask = (order == 0) & (rows > 0)
        if not mask.any():
            break
        ms = int(np.where(mask, rows, np.int64(1) << 60).argmin())
        c = (c + 1) & 0xFF  # byte counter, wraps like the reference's
        order[ms] = c
        work[ms, :] = 0
        work[:, ms] = 0
    r2 = np.zeros(1 << 16, np.int64)
    if len(d) >= 3:
        oa, ob, oc = order[d[:-2]], order[d[1:-1]], order[d[2:]]
        m = (oc > ob) & (oa >= ob)
        np.add.at(r2, (d[:-2].astype(np.int64) << 8) + d[1:-1], m.astype(np.int64))
    return r2


def _fit1s(d, n_initial: int = 100, n_local: int = 100, seed: int = 0):
    """IT-1s (fit1s): random-restart local search over alphabet orders
    maximizing the skipped (ascending-digram) complexity, then IT-1 volume
    under the best order.  Deterministic via numpy's PCG64(seed) — the
    reference uses C ``srand(0)/rand()`` so the sample stream differs; the
    procedure (restarts, swap moves, delta table ``rd``) is the same."""
    r = _digrams(d)
    comp = _complexity(r)
    rd = comp - comp.T  # rd[b,a] = complexity(r[b,a]) - complexity(r[a,b])
    rng = np.random.default_rng(seed)
    best_order = np.arange(256, dtype=np.int64)
    best_score = 0  # replicates the reference's zero seed (reorder.c:266
    # computes (i<<8) < (i&0xFF), which never holds — kept as-is)
    iu = np.triu_indices(256, k=1)
    for _ in range(n_initial):
        order = rng.permutation(256).astype(np.int64)
        cur = int(comp[order[iu[0]], order[iu[1]]].sum())
        left = n_local
        while left > 1:
            left -= 1
            a, b = int(rng.integers(256)), int(rng.integers(256))
            if a > b:
                a, b = b, a
            q, e = order[a], order[b]
            add = int(rd[e, q])
            mid = order[a + 1 : b]
            if mid.size:
                add += int(rd[mid, q].sum() + rd[e, mid].sum())
            if add > 0:
                left = n_local
                cur += add
                order[a], order[b] = e, q
        if cur > best_score:
            best_order = order.copy()
            best_score = cur
    inv = np.empty(256, np.int64)
    inv[best_order] = np.arange(256)
    keep = inv[:, None] >= inv[None, :]  # a-rank >= b-rank: sorted directly
    return r[keep].reshape(-1)


def reorder_direct_volume(data: np.ndarray) -> dict[str, dict[str, float]]:
    """Direct-sort volume of the seven IT split variants
    (a6/tool/reorder/reorder.c:346-359 estimator table).  Per variant:
    ``flat`` = directly-sorted fraction of n, ``logc`` = the reference's
    n*log(n) complexity metric normalized by n."""
    d = np.asarray(data, np.uint8)
    n = max(len(d), 1)
    out = {}
    for name, fn in (
        ("it1", _fit1),
        ("it1x", _fit1x),
        ("it1y", _fit1y),
        ("it1s", _fit1s),
        ("it12x", _fit12x),
        ("it2", _fit2),
        ("it2x1", _fit2x1),
    ):
        groups = fn(d) if len(d) >= 3 else np.zeros(1, np.int64)
        out[name] = {
            "flat": float(groups.sum()) / n,
            "logc": float(_complexity(groups).sum()) / n,
        }
    return out


def radix_direction_bench(size: int = 1 << 15, iters: int = 512) -> dict[str, float]:
    """Counting-sort scan-direction microbenchmark (tool/radix_dir), on the
    host: seconds for ascending vs descending accumulation over a byte
    histogram with numpy."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size, dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(iters):
        c = np.bincount(data, minlength=256)
        np.cumsum(c)
    asc = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        c = np.bincount(data, minlength=256)
        np.cumsum(c[::-1])
    desc = time.perf_counter() - t0
    return {"ascending_s": asc, "descending_s": desc}


def _route_volumes(order: int) -> list[float]:
    """Expected group-volume table (a5/tool/route/route.cpp fill_sizes,
    :264-297): node gid's implicit bit string is gid's binary form minus
    the leading 1; volume via the reference's factorial/sign recurrence."""
    size = 1 << (order + 1)
    vol = [0.0] * size
    vol[1] = 1.0
    for i in range(2, size):
        num = i.bit_length() - 1
        b = [(i >> (num - 1 - j)) & 1 for j in range(num)] + [1]
        kf = 1.0
        s = 0.0
        for k in range(num + 1):
            kf /= k + 1
            if not b[k]:
                continue
            cur = kf
            for j in range(k):
                cur *= 1 - 2 * b[j]
            t = 1
            for j in range(k + 1, num):
                t = t + t + b[j]
            s += cur * vol[t]
        vol[i] = s
    return vol


def _route_links(order: int) -> dict[int, list[tuple[str, tuple[int, ...]]]]:
    """Derivation options per group (route.cpp fill_links, :299-351):
    SUFFIX from the two child groups, PREFIX from the drop-first-bit group
    (unless it is an ancestor), PERIOD from the deduped sliding windows of
    the doubled mask.  Options are source *sets* — the reference enumerates
    source orderings (Dependance::fill) but its volume count sums all
    sources regardless of order, so sets are volume-equivalent."""
    size = 1 << (order + 1)
    deps: dict[int, list[tuple[str, tuple[int, ...]]]] = {i: [] for i in range(1, size)}
    for i in range(1, size):
        if 2 * i < size:
            deps[i].append(("SUFFIX", (2 * i, 2 * i + 1)))
        if i != 1:
            d = i.bit_length() - 1
            mask = (1 << (d - 1)) - 1
            j = (i & mask) ^ (mask + 1)
            anc, cur = False, i
            while cur:
                if cur == j:
                    anc = True
                cur >>= 1
            if not anc:
                deps[i].append(("PREFIX", (j,)))
        if i != 1 and 2 * i < size:
            d = i.bit_length() - 1
            mask = (2 << d) - 1
            m = i ^ (1 << d)
            k = (m << d) + m + (1 << (d + d))
            srcs: list[int] = []
            for l in range(d):
                gid = ((k >> l) & mask) ^ 1
                if any(gid == (((k >> e) & mask) ^ 1) for e in range(l)):
                    continue
                if any(gid == ((k >> e) & mask) for e in range(d)):
                    continue
                srcs.append((2 << d) + gid)
            if srcs:
                deps[i].append(("PERIOD", tuple(srcs)))
    return deps


def route_search(order: int = 3) -> dict:
    """Derivation-plan brute force (a5/tool/route/route.cpp:355-371).

    Searches per-group choices (sort directly, or derive via one SUFFIX /
    PREFIX / PERIOD dependency) for the plan minimizing total directly-
    sorted volume, with the reference's semantics: a group is free if it or
    any trie ancestor was already sorted (State::check :352); re-entering a
    group mid-derivation (a cycle) costs the 2.0 LOCKED penalty (:131-133);
    plans at or above the 1.5 record seed are pruned (State :192).

    Returns {"volume": best total, "plan": {gid: "DIRECT" | (type, srcs)}}.

    Note: the reference binary's own enumerator (Group::inc) terminates
    after the trivial all-direct plan on this build (prints 1.000); this
    port searches the same modeled space exhaustively with the same
    record-bound pruning and finds 0.25 for ORDER=3.
    """
    vol = _route_volumes(order)
    deps = _route_links(order)
    best = {"volume": 1.5, "plan": None}
    choices: dict[int, int] = {}

    def evaluate():
        """Volume of the current partial assignment from the root; returns
        (first unassigned reachable gid or None, volume so far)."""
        sorted_done: set[int] = set()
        visiting: set[int] = set()
        state = {"total": 0.0, "need": None}

        def count(g: int) -> None:
            if state["need"] is not None:
                return
            a = g
            while a:
                if a in sorted_done:
                    return
                a >>= 1
            if g in visiting:
                state["total"] += 2.0  # LOCKED
                return
            if g not in choices:
                state["need"] = g
                return
            visiting.add(g)
            c = choices[g]
            if c < 0:
                state["total"] += vol[g]
            else:
                for src in deps[g][c][1]:
                    count(src)
            visiting.discard(g)
            sorted_done.add(g)

        count(1)
        return state["need"], state["total"]

    def dfs() -> None:
        need, total = evaluate()
        if total >= best["volume"]:
            return
        if need is None:
            best["volume"] = total
            best["plan"] = dict(choices)
            return
        for c in [-1] + list(range(len(deps[need]))):
            choices[need] = c
            dfs()
        del choices[need]

    dfs()
    plan = {
        g: ("DIRECT" if c < 0 else (deps[g][c][0], deps[g][c][1]))
        for g, c in (best["plan"] or {}).items()
    }
    return {"volume": best["volume"], "plan": plan}


def varadix_orders(data: np.ndarray, rad_pow: int = 16) -> dict[str, int | float]:
    """Variable-length radix key study (a6/tool/varadix).

    The reference compares two radix-key schemes over the dense alphabet of
    a file: exact base-``nd`` keys packing as many symbols as fit in the
    radix budget (presize.c:25-48) vs power-of-2 bit keys using
    ceil(log2(nd)) bits per symbol (2pow.c:30-41).  Returns, for a
    ``2**rad_pow`` radix budget: the dense alphabet size, the context order
    each scheme achieves, and the bucket-utilization ratio of the pow-2
    scheme (exact keys always use the budget fully).
    """
    counts = np.bincount(np.asarray(data, np.uint8).ravel(), minlength=256)
    nd = int((counts > 0).sum())
    if nd <= 1:
        return {"symbols": nd, "exact_order": 0, "pow2_order": 0, "pow2_utilization": 0.0}
    max_rad = 1 << rad_pow
    ord_exact = 0
    v = 1
    while v * nd <= max_rad:
        v *= nd
        ord_exact += 1
    bits = int(np.ceil(np.log2(nd)))
    ord_pow2 = rad_pow // bits
    util = (nd ** ord_pow2) / float(1 << (bits * ord_pow2)) if ord_pow2 else 0.0
    return {
        "symbols": nd,
        "exact_order": ord_exact,
        "pow2_order": ord_pow2,
        "pow2_utilization": util,
    }


def memory_report(n: int, impl: str = "v3") -> dict[str, float]:
    """Working-set accounting per input byte: the parity of the reference's
    memory reporters (a6 ``bwt_memory`` bwt.c:225-230, a7 ``countMemory``
    archon.cpp:855-857; design budget 5N, README.md:15).

    Counts the tensors the port holds on the device at the peak of one
    n-byte block, which is inside a merge level of a full round's 4-key sort
    (``ops/sort.py``): ``v3`` is ``core.fast2.bwt_v3``, ``doubling`` is
    ``core.doubling.suffix_array``.  Bytes per input byte, i32 = 4; the
    tuple buffers hold 4 keys + the index and are padded to a tile multiple,
    which the per-byte figures leave out."""
    i32 = 4
    sort = {
        "rank_padded": 2 * i32,      # rank + n off-end sentinels, sliced for the shifts
        "key_matrix": 4 * i32,       # torch.stack of the four keys
        "iota": i32,
        "tuple_buffer": 5 * i32,     # (C + 1, n_pad), the level's input
        "pingpong_buffer": 5 * i32,  # the level's output
    }
    if impl == "v3":
        live = {
            "input+prev_bytes": 2,
            # the round before, alive until this one's results replace it:
            # sorted index, sorted ranks, active flags, carried payload, and
            # the rank snapshot before the one being sorted
            "previous_round": 2 * i32 + 2 + i32,
            "rank": i32,             # the deferred inversion, key 0 of this sort
            **sort,
        }
    elif impl == "doubling":
        live = {"input_bytes": 1, "rank": i32, **sort}
    else:
        raise ValueError(impl)
    total = sum(live.values())
    return {**{k: float(v) for k, v in live.items()},
            "bytes_per_input_byte": float(total),
            "total_bytes": float(total) * n}
