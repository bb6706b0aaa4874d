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

from ..ops.sort import sort_operands, sort_rows
from .doubling import SENT_LARGE, SENT_SMALL, _invert_permutation

_I32 = torch.int32
_WALK_K = 4096  # parallel chain count of the lockstep walk


def lf_successor(L: torch.Tensor, base, sentinel: str, starts: torch.Tensor | None = None):
    """Successor table P (int32): P[i] = bucket_start[L[i]] + occ(i), with
    the base twist.  occ comes from one stable sort of (L, index).
    ``starts`` relocates the bucket bases only (the a6 var inverse needs
    Huffman-code-ordered buckets, see core/a6.py).

    A (B, n) ``L`` with a (B,) ``base`` gives the (B, n) tables of all rows at
    once, through one ``sort_rows`` call (``_lf_successor_rows``)."""
    if L.dim() == 2:
        return _lf_successor_rows(L, base, sentinel)
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


def _lf_successor_rows(L: torch.Tensor, base, sentinel: str) -> torch.Tensor:
    """``lf_successor`` of every row of a (B, n) ``L`` with its own base: the
    same arithmetic along dim 1, nothing read back to the host."""
    B, n = L.shape
    if B * n >= 1 << 31:
        raise ValueError("lf_successor: the batch must hold fewer than 2^31 elements")
    dev = L.device
    Li = L.to(_I32)
    base = torch.as_tensor(base, dtype=_I32, device=dev).reshape(B, 1)
    rows = torch.arange(B, dtype=_I32, device=dev)[:, None]
    counts = torch.bincount((Li + rows * 256).reshape(-1), minlength=B * 256).view(B, 256)
    natural = (torch.cumsum(counts, 1) - counts).to(_I32)
    counts = counts.to(_I32)

    iota = torch.arange(n, dtype=_I32, device=dev).expand(B, n)
    _, sorted_idx = sort_rows((Li,), (iota,))  # stable within a byte
    slot = torch.empty_like(iota, memory_format=torch.contiguous_format)
    slot.view(-1)[(sorted_idx + rows * n).reshape(-1)] = iota.reshape(-1)
    # indexing the flattened tables with int32 saves the int64 index a gather needs
    byte_slot = Li + rows * 256
    occ = slot - natural.reshape(-1)[byte_slot]

    at_base = (base + rows * n).reshape(-1)
    base_byte = Li.reshape(-1)[at_base][:, None]
    same = Li == base_byte
    if sentinel == SENT_SMALL:
        occ = occ + ((iota < base) & same).to(_I32)
        occ.view(-1)[at_base] = 0
    else:
        occ = occ - ((iota > base) & same).to(_I32)
        occ.view(-1)[at_base] = (counts.reshape(-1)[base_byte + rows * 256] - 1).reshape(-1)
    return natural.reshape(-1)[byte_slot] + occ


def _compose_perm(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """c[i] = g[h[i]] for a permutation ``h``: one gather (the TPU form is
    two sorts; see the module docstring)."""
    return g[h]


def pointer_walk(L: torch.Tensor, P: torch.Tensor, base) -> torch.Tensor:
    """Emit L[base], L[P[base]], L[P[P[base]]], ...

    Up to 2K elements: plain doubling, each round extends the known prefix
    of the walk with one gather and squares the jump table.  Beyond: square
    only up to P^K, seed K chain heads spaced K apart along the cycle, then
    walk all K chains in lockstep, ceil(n/K) steps of two K-wide gathers.
    The loop reads nothing back to the host.

    A (B, n) ``L`` and ``P`` with a (B,) ``base`` walk all rows in the same
    lockstep loop: the rows' tables are laid end to end as one table of
    B * n successors (row b's shifted by b * n), so a step is the same two
    gathers, B * K wide."""
    if L.dim() == 1:
        start = torch.as_tensor(base, dtype=_I32, device=L.device).reshape(1)
        return _walk(L, P, start, L.shape[0])[0]
    B, n = L.shape
    if B * n >= 1 << 31:
        raise ValueError("pointer_walk: the batch must hold fewer than 2^31 elements")
    offs = torch.arange(B, dtype=_I32, device=L.device) * n
    start = torch.as_tensor(base, dtype=_I32, device=L.device).reshape(B) + offs
    return _walk(L.reshape(-1), (P + offs[:, None]).reshape(-1), start, n)


def _walk(L: torch.Tensor, P: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """The walks of B disjoint n-cycles of the flat successor table ``P``,
    one from each entry of ``start``: (B, n) symbols of the flat ``L``."""
    B = start.shape[0]
    if n <= 2 * _WALK_K:
        rounds = max(1, math.ceil(math.log2(n))) if n > 1 else 0
        pos = torch.zeros((B, n), dtype=_I32, device=L.device)
        pos[:, 0] = start
        filled, jump = 1, P
        for _ in range(rounds):
            take = min(filled, n - filled)
            if take > 0:
                pos[:, filled : filled + take] = jump[pos[:, :take]]
                filled += take
            if filled < n:
                jump = jump[jump]
        return L[pos]

    k = _WALK_K
    pos = torch.zeros((B, k), dtype=_I32, device=L.device)
    pos[:, 0] = start
    filled, jump = 1, P
    while filled < k:
        pos[:, filled : 2 * filled] = jump[pos[:, :filled]]
        filled *= 2
        jump = _compose_perm(jump, jump)
    # jump is now P^K; pos holds the first K walk positions of every row

    T = -(-n // k)
    out = torch.empty((B, T, k), dtype=L.dtype, device=L.device)
    for t in range(T):
        out[:, t] = L[pos]
        pos = jump[pos]
    # cell (b, t, j) holds row b's walk step t*K + j, so the row-major flatten
    # is walk order; steps past n wrap the cycle and are cut off
    return out.reshape(B, -1)[:, :n]


def bwt_inverse_with_starts(L: torch.Tensor, base: int, starts: torch.Tensor) -> torch.Tensor:
    """Inverse with caller-supplied (e.g. code-ordered) bucket starts, in the
    base-last roll convention of the a6/a7 family."""
    if L.shape[0] == 0:
        return torch.zeros(0, dtype=torch.uint8, device=L.device)
    return pointer_walk(L, lf_successor(L, base, SENT_LARGE, starts), base)


def bwt_inverse(L: torch.Tensor, base, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Invert (L, base) on L's device; returns the reverse of the pre-BWT
    string, which for the a4/a7 formats is the original, unreversed input.
    A (B, n) ``L`` with a (B,) ``base`` inverts every row, all in one walk."""
    if L.numel() == 0:
        return torch.zeros(L.shape, dtype=torch.uint8, device=L.device)
    return pointer_walk(L, lf_successor(L, base, sentinel), base)
