"""Block-parallel BWT pipeline (port of ``archon_tpu/parallel/blocks.py``).

Blocks are the rows of a ``(num_blocks, block_len)`` tensor on one device.
The JAX package shards that axis over a ``dp`` device mesh; the port has no
mesh yet (``make_mesh`` and ``mesh=`` come with the multi-device slice over
``torch.distributed``), so every function here runs its batch on the device
its tensor lies on.
"""

from __future__ import annotations

import torch

from ..core.batched import (
    bwt_batched_micro,
    bwt_batched_micro_certified,
    bwt_batched_v3,
    bwt_batched_v3_certified,
)
from ..core.doubling import SENT_SMALL
from ..core.unbwt import bwt_inverse


def bwt_blocks(blocks: torch.Tensor, sentinel: str = SENT_SMALL):
    """Forward-BWT a (num_blocks, block_len) uint8 tensor: (L2, base2)."""
    return bwt_batched_v3(blocks, sentinel)


def bwt_blocks_certified(blocks: torch.Tensor, sentinel: str = SENT_SMALL):
    """Forward BWT with the per-block LF certificate: (L2, base2, ok2)."""
    return bwt_batched_v3_certified(blocks, sentinel)


def bwt_blocks_micro(blocks: torch.Tensor, sentinel: str = SENT_SMALL):
    """Fast-path forward BWT (no cascade): (L2, base2, resolved2).  Rows
    with resolved2 False must be recomputed by the caller: see
    ``core.batched.bwt_batched_micro``."""
    return bwt_batched_micro(blocks, sentinel)


def bwt_blocks_micro_certified(blocks: torch.Tensor, sentinel: str = SENT_SMALL):
    """Fast-path forward BWT with the per-block LF certificate:
    (L2, base2, ok2, resolved2)."""
    return bwt_batched_micro_certified(blocks, sentinel)


def unbwt_blocks(L: torch.Tensor, base, sentinel: str = SENT_SMALL) -> torch.Tensor:
    """Inverse-BWT a batch of (L, base) blocks, row by row through
    ``core.unbwt.bwt_inverse``; ``base`` is a sequence or tensor of ints."""
    rows = [bwt_inverse(L[b], int(base[b]), sentinel) for b in range(L.shape[0])]
    return torch.stack(rows) if rows else L.clone()
