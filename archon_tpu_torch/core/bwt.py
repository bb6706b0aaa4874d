"""The suffix-array certificate (port of ``verify_sa`` of
``archon_tpu/core/bwt.py``; ``bwt_forward`` and ``bwt_forward_fast`` there
rest on the v1 sorters, which the port does not have yet)."""

from __future__ import annotations

import torch

from .doubling import SENT_SMALL, rank_of


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
