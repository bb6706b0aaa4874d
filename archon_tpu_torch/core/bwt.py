"""Forward BWT on the v1 suffix sorters, and the suffix-array certificate
(port of ``archon_tpu/core/bwt.py``).

The forward transform (reference: a4/src/archon.c:227-234 ``encode``,
a7/src/archon.cpp:887-900 ``enWrite``) is a single gather off the suffix
array; the verifier is the vectorized equivalent of a4's O(N) LF-consistency
check (a4/src/archon.c:210-225 ``verify``, a7/src/archon.cpp:862-874
``validate``).
"""

from __future__ import annotations

import torch

from .doubling import SENT_SMALL, _invert_permutation, rank_of, suffix_array


def bwt_forward(data: torch.Tensor, sentinel: str = SENT_SMALL, sort_fn=None):
    """BWT of ``data`` (uint8) through ``core.doubling.suffix_array``:
    (L, base, sa), base an int.

    L[i] = data[(sa[i]-1) mod n]; base = rank of the full suffix, the index
    where ``sa == 0``."""
    n = data.shape[0]
    sa = suffix_array(data, sentinel, sort_fn)
    if n == 0:
        return data, 0, sa
    L = data[(sa - 1) % n]
    return L, int(torch.argmax((sa == 0).to(torch.uint8))), sa


def verify_sa(data: torch.Tensor, sa: torch.Tensor, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """True (a 0-d bool tensor) iff ``sa`` is the suffix array of ``data``
    (uint8) under the convention.

    Checks, all O(n):
      1. sa is a permutation of [0, n);
      2. adjacent sorted suffixes are strictly increasing under the
         (char, next-suffix-rank) order with sentinel semantics: the
         standard single-pass SA certificate.
    An entry outside [0, n) fails check 1 (the indexed reads clamp it first;
    JAX's scatter drops it)."""
    n = data.shape[0]
    if n == 0:
        return torch.ones((), dtype=torch.bool, device=data.device)
    in_range = (sa >= 0) & (sa < n)
    sa = sa.clamp(0, n - 1)
    perm_ok = in_range.all() & (torch.bincount(sa, minlength=n) == 1).all()

    rank = rank_of(sa)
    # rank of the suffix following position p (sentinel rank off the end)
    off = -1 if sentinel == SENT_SMALL else n + 1
    nxt = torch.where(sa + 1 < n, rank[(sa + 1).clamp(max=n - 1)], off)
    c = data[sa].to(torch.int32)
    adj_ok = ((c[:-1] < c[1:]) | ((c[:-1] == c[1:]) & (nxt[:-1] < nxt[1:]))).all()
    return perm_ok & adj_ok


def bwt_forward_fast(data: torch.Tensor, sentinel: str = SENT_SMALL):
    """Forward BWT on the narrowed suffix sorter (``core.fast``): (L, base,
    rank), rank the inverse suffix array and base an int.  Emits straight
    from the rank array: L[rank[p]] = data[p-1 mod n] is one scatter and
    base = rank[0], so the suffix array is never built."""
    from .fast import suffix_ranks_fused

    rank = suffix_ranks_fused(data, sentinel)
    if data.shape[0] == 0:
        return data, 0, rank
    return _invert_permutation(rank, torch.roll(data, 1)), int(rank[0]), rank
