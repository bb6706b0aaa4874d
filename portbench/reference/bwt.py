"""The plain reference BWT: prefix doubling by stable ``torch.sort``.

Written for the benchmark from the Archon format's definition (the golden
model's semantics, ``archon_tpu_torch/golden/sa.py``): a frame holds the
terminator-convention BWT of the REVERSED block, with end-of-string below
every byte for a4 and above every byte for a7.  It runs on any device; on the
card it is the plain ``torch.sort`` chain, no kernel of the program.

``depth`` stops the doubling once suffixes are ordered by their first
``depth`` bytes and leaves deeper ties in position order (a bounded-context
sort, as in Schindler's transform).  That breaks the format's guarantee of an
exact BWT: it is the control that the comparison has to reject.
"""

from __future__ import annotations

import numpy as np
import torch

GENERATIONS = ("a4", "a7")


def frame_bwt(block, generation: str, device, depth: int | None = None) -> tuple[np.ndarray, int]:
    """(L, base) of one frame: the BWT of the reversed ``block`` (bytes or a
    uint8 numpy array)."""
    if generation not in GENERATIONS:
        raise ValueError(f"unknown generation {generation!r}")
    arr = np.frombuffer(bytes(block), np.uint8) if not isinstance(block, np.ndarray) else block
    n = len(arr)
    if n == 0:
        return np.zeros(0, np.uint8), 0
    s = torch.from_numpy(arr[::-1].copy()).to(device)
    sa = suffix_array(s, generation == "a7", depth)
    L = s[(sa - 1) % n]
    base = int(torch.nonzero(sa == 0)[0, 0])
    return L.cpu().numpy(), base


def suffix_array(s: torch.Tensor, end_large: bool, depth: int | None = None) -> torch.Tensor:
    """Suffix array of the uint8 tensor ``s`` (int64, on its device).  On a
    prefix tie the shorter suffix sorts first, or last with ``end_large``."""
    n = s.numel()
    end = n + 256 if end_large else -1  # the rank of the position past the end
    rank = s.to(torch.int64)
    k = 1  # suffixes are ordered by their first k bytes
    while True:
        nxt = torch.full_like(rank, end)
        nxt[: max(n - k, 0)] = rank[k:]
        key = (rank + 1) * (n + 258) + (nxt + 1)
        key_sorted, sa = torch.sort(key, stable=True)
        head = torch.ones_like(key_sorted)
        head[0] = 0
        head[1:] = key_sorted[1:] != key_sorted[:-1]
        ranks_sorted = torch.cumsum(head, 0)
        k *= 2
        if int(ranks_sorted[-1]) == n - 1 or (depth is not None and k >= depth):
            return sa
        rank = torch.empty_like(rank)
        rank[sa] = ranks_sorted
