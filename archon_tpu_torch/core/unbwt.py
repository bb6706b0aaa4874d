"""Inverse BWT on the device: the LF successor table by one stable sort, then
a pointer-doubling and lockstep chain walk (port of
``archon_tpu/core/unbwt.py``; names and structure kept).

Replaces, by function:

- ``lf_successor``            <- ``archon_tpu/core/unbwt.py:27`` (``lf_successor``)
- ``_compose_perm``           <- ``:68`` (``_compose_perm``)
- ``pointer_walk``            <- ``:81`` (``pointer_walk``)
- ``bwt_inverse_with_starts`` <- ``:134`` (``bwt_inverse_with_starts``)
- ``bwt_inverse``             <- ``:144`` (``bwt_inverse``)

The reference inverse builds the LF table by a counting pass and walks the
chain serially.  Here the occurrence counts come from one stable 1-key sort
(``ops.sort.sort_operands``: the Hopper tile-sort and merge-level kernels on
a CUDA tensor), and the walk squares the jump table up to P^K and then walks
K chains in lockstep.

TPU workaround dropped: the JAX ``_compose_perm`` computes g[h] as two sorts
(sort h to get h^-1, then sort g by h^-1), because a random gather cost 2.5x
two sorts on the TPU.  On the GPU it is the gather ``g[h]``; ``h`` is a
permutation, so both forms give the same array.

The a4-vs-a7 convention survives into decode: the successor counts roll the
base index first (a4, ``sentinel="small"``) or last (a7 and a6, ``"large"``).
"""

from __future__ import annotations

import math

import torch

from ..ops.sort import sort_operands
from .doubling import SENT_LARGE, SENT_SMALL, _invert_permutation

_I32 = torch.int32
_WALK_K = 4096  # parallel chain count of the lockstep walk


def lf_successor(L: torch.Tensor, base: int, sentinel: str, starts: torch.Tensor | None = None):
    """Successor table P (int32): P[i] = bucket_start[L[i]] + occ(i), with
    the base twist.  occ comes from one stable sort of (L, index).
    ``starts`` relocates the bucket bases only (the a6 var inverse needs
    Huffman-code-ordered buckets, see core/a6.py)."""
    n = L.shape[0]
    dev = L.device
    Li = L.to(_I32)
    counts = torch.bincount(Li, minlength=256).to(_I32)
    # occ is measured against byte-ordered slots (the order the stable sort
    # gives); custom ``starts`` only move the bucket bases in the final add
    natural = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1].to(_I32)])
    starts = natural if starts is None else starts.to(device=dev, dtype=_I32)

    iota = torch.arange(n, dtype=_I32, device=dev)
    _, sorted_idx = sort_operands((Li,), (iota,))  # stable within a byte
    occ = _invert_permutation(sorted_idx, iota) - natural[Li]  # earlier equal bytes

    # the base is taken first (a4, 'small') or last (a7, 'large') instead of
    # at its own index: shift the counts of the same byte's other slots
    same = Li == Li[base]
    if sentinel == SENT_SMALL:
        occ = occ + ((iota < base) & same).to(_I32)
        occ[base] = 0
    else:
        occ = occ - ((iota > base) & same).to(_I32)
        occ[base] = counts[Li[base]] - 1
    return starts[Li] + occ


def _compose_perm(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """c[i] = g[h[i]] for a permutation ``h``: one gather (the TPU form is
    two sorts; see the module docstring)."""
    return g[h]


def pointer_walk(L: torch.Tensor, P: torch.Tensor, base: int) -> torch.Tensor:
    """Emit L[base], L[P[base]], L[P[P[base]]], ...

    Up to 2K elements: plain doubling, each round extends the known prefix
    of the walk with one gather and squares the jump table.  Beyond: square
    only up to P^K, seed K chain heads spaced K apart along the cycle, then
    walk all K chains in lockstep, ceil(n/K) steps of two K-wide gathers.
    The loop reads nothing back to the host."""
    n = L.shape[0]
    if n <= 2 * _WALK_K:
        rounds = max(1, math.ceil(math.log2(n))) if n > 1 else 0
        pos = torch.zeros(n, dtype=_I32, device=L.device)
        pos[0] = base
        filled, jump = 1, P
        for _ in range(rounds):
            take = min(filled, n - filled)
            if take > 0:
                pos[filled : filled + take] = jump[pos[:take]]
                filled += take
            if filled < n:
                jump = jump[jump]
        return L[pos]

    k = _WALK_K
    pos = torch.zeros(k, dtype=_I32, device=L.device)
    pos[0] = base
    filled, jump = 1, P
    while filled < k:
        pos[filled : 2 * filled] = jump[pos[:filled]]
        filled *= 2
        jump = _compose_perm(jump, jump)
    # jump is now P^K; pos holds the first K walk positions

    T = -(-n // k)
    out = torch.empty((T, k), dtype=L.dtype, device=L.device)
    for t in range(T):
        out[t] = L[pos]
        pos = jump[pos]
    # cell (t, j) holds walk step t*K + j, so the row-major flatten is walk
    # order; steps past n wrap the cycle and are cut off
    return out.reshape(-1)[:n]


def bwt_inverse_with_starts(L: torch.Tensor, base: int, starts: torch.Tensor) -> torch.Tensor:
    """Inverse with caller-supplied (e.g. code-ordered) bucket starts, in the
    base-last roll convention of the a6/a7 family."""
    if L.shape[0] == 0:
        return torch.zeros(0, dtype=torch.uint8, device=L.device)
    return pointer_walk(L, lf_successor(L, base, SENT_LARGE, starts), base)


def bwt_inverse(L: torch.Tensor, base: int, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Invert (L, base) on L's device; returns the reverse of the pre-BWT
    string, which for the a4/a7 formats is the original, unreversed input."""
    if L.shape[0] == 0:
        return torch.zeros(0, dtype=torch.uint8, device=L.device)
    return pointer_walk(L, lf_successor(L, base, sentinel), base)
