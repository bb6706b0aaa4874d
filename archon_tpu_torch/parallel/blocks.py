"""Block-parallel (DP) BWT pipeline over a device mesh (port of
``archon_tpu/parallel/blocks.py``).

Blocks are the rows of a ``(num_blocks, block_len)`` tensor.  The JAX package
shards that axis over the ``dp`` axis of a ``jax.sharding.Mesh`` and lets XLA
partition the batched transform; PyTorch has no mesh, so the port's ``Mesh``
is a small object of its own and a ``dp`` mesh splits the rows by hand: the
batch is cut into one chunk a device, each chunk runs on its device, and the
results are concatenated on the first.  Nothing crosses between chunks.

A device may stand in a mesh more than once.  That is the port's counterpart
of the JAX package's forced host device count: ``make_mesh({"sp": 8},
devices=["cpu"] * 8)`` is an 8-shard mesh on the CPU, and eight entries of
``cuda:0`` are how one GPU runs an 8-shard megablock (``parallel/megablock``).
Without a mesh every function here runs its batch on the device its tensor
lies on.
"""

from __future__ import annotations

import math

import torch

from ..core.batched import (
    bwt_batched_micro,
    bwt_batched_micro_certified,
    bwt_batched_v3,
    bwt_batched_v3_certified,
)
from ..core.doubling import SENT_SMALL
from ..core.unbwt import bwt_inverse


class Mesh:
    """Named axes over a list of devices: ``axes`` (the names), ``shape``
    (name -> size), ``devices`` (``torch.device``s in row-major order, repeats
    allowed), ``size``.  ``group`` is the ``torch.distributed`` process group
    whose rank r owns device r, or None when one process drives every device."""

    def __init__(self, devices, axes: dict[str, int], group=None):
        self.devices = [torch.device(d) for d in devices]
        self.axes = tuple(axes)
        self.shape = dict(axes)
        self.size = len(self.devices)
        self.group = group
        if math.prod(self.shape.values()) != self.size:
            raise ValueError(f"cannot lay {self.size} devices out as {self.shape}")

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"


def make_mesh(axes: dict[str, int] | None = None, devices=None, group=None) -> Mesh:
    """Build a mesh; default 1D 'dp' over all CUDA devices (raises where
    there is none).  ``group`` marks a mesh whose devices are one rank each of
    a ``torch.distributed`` process group."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices=, e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if axes is None:
        axes = {"dp": len(devices)}
    return Mesh(devices, axes, group)


def _over_mesh(fn, mesh: Mesh | None, *batched):
    """``fn(*batched)`` with the leading axis of every tensor split over the
    mesh's devices: one chunk a device, results concatenated on the first."""
    if mesh is None:
        return fn(*batched)
    rows = batched[0].shape[0]
    if rows % mesh.size:
        raise ValueError(f"{rows} rows do not divide over a mesh of {mesh.size}")
    chunks = [t.chunk(mesh.size) for t in batched]
    outs = [fn(*(c[i].to(dev) for c in chunks)) for i, dev in enumerate(mesh.devices)]
    first = mesh.devices[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(first) for o in outs])
    return tuple(torch.cat([o[j].to(first) for o in outs]) for j in range(len(outs[0])))


def bwt_blocks(blocks: torch.Tensor, sentinel: str = SENT_SMALL, mesh: Mesh | None = None):
    """Forward-BWT a (num_blocks, block_len) uint8 tensor, dp-sharded:
    (L2, base2)."""
    return _over_mesh(lambda b: bwt_batched_v3(b, sentinel), mesh, blocks)


def bwt_blocks_certified(blocks: torch.Tensor, sentinel: str = SENT_SMALL,
                         mesh: Mesh | None = None):
    """Forward BWT with the per-block LF certificate: (L2, base2, ok2)."""
    return _over_mesh(lambda b: bwt_batched_v3_certified(b, sentinel), mesh, blocks)


def bwt_blocks_micro(blocks: torch.Tensor, sentinel: str = SENT_SMALL, mesh: Mesh | None = None):
    """Fast-path forward BWT (no cascade): (L2, base2, resolved2).  Rows
    with resolved2 False must be recomputed by the caller: see
    ``core.batched.bwt_batched_micro``."""
    return _over_mesh(lambda b: bwt_batched_micro(b, sentinel), mesh, blocks)


def bwt_blocks_micro_certified(blocks: torch.Tensor, sentinel: str = SENT_SMALL,
                               mesh: Mesh | None = None):
    """Fast-path forward BWT with the per-block LF certificate:
    (L2, base2, ok2, resolved2)."""
    return _over_mesh(lambda b: bwt_batched_micro_certified(b, sentinel), mesh, blocks)


def unbwt_blocks(L: torch.Tensor, base, sentinel: str = SENT_SMALL,
                 mesh: Mesh | None = None) -> torch.Tensor:
    """Inverse-BWT a batch of (L, base) blocks, dp-sharded: all rows in one
    lockstep walk (``core.unbwt.bwt_inverse`` on a (B, n) tensor); ``base`` is
    a sequence or tensor of ints."""
    base = torch.as_tensor(base, dtype=torch.int32, device=L.device)
    return _over_mesh(lambda l, b: bwt_inverse(l, b, sentinel), mesh, L, base)
