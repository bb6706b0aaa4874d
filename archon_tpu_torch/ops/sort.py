"""Stable multi-key sort for the forward BWT: Hopper tile sort + merge levels.

Port of ``archon_tpu/ops/pallas_sort.py``.  Its two Pallas kernels become two
CUDA kernels in ``archon_tpu_torch/csrc/sort.cu`` (built by ``ops/_build.py``):

- ``sort_tiles`` (K1) replaces ``sort_tiles`` / ``_tile_sort_kernel``
  (``pallas_sort.py:393`` / ``:385``): a bitonic network per T-element tile,
  one thread block per tile, the tile in shared memory;
- ``merge_level`` (K2) replaces ``_merge_level`` / ``_merge_kernel``
  (``pallas_sort.py:317`` / ``:265``): merged runs of L -> 2L, each block
  computing its own merge-path split (in place of ``_merge_partition`` and
  scalar prefetch).

``sort_operands`` drives K1 and then the K2 levels; it is the port's sort at
every ``lax.sort`` site of ``core/fast2``.  Unlike the TPU kernels, which
sort the operand values, both kernels sort a permutation of element indices
and read the int32 keys from one (K, n) matrix in device memory, so the key
count is a run-time value; payloads of any dtype are gathered by the final
permutation.

Stability: ``lax.sort`` is stable and the JAX pipeline relies on it, while a
bitonic network is not.  Both kernels therefore compare on (keys..., index):
the element index is the implicit last key, unique, which makes the order
total and equal to a stable sort by the keys -- the same as appending an
iota key at every sort site.  Padding up to a tile multiple has index >= n
and sorts after every real element by that index, never by value, so key
values need no reserved sentinel (0x7FFFFFFF is a real key in core/fast2).

Each kernel has a plain PyTorch twin (``sort_tiles_ref``, ``merge_level_ref``,
``sort_operands_ref``: stable ``torch.sort`` passes from the last key to the
first, then a gather).  A wrapper takes its twin only for tensors on the CPU;
on a CUDA tensor it launches its kernel or raises.  ``sort_tiles.launches``
and ``merge_level.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

TILE = 2048  # K1's tile, kSortTile in csrc/sort.cu: 1024 threads, 8 KiB smem
MAX_WIDTH = 1 << 30  # sort widths must stay below this (int32 indices, padding)


def _key_matrix(keys) -> torch.Tensor:
    """Validate a (K, n) key matrix: int32, contiguous, 2-D, K >= 1."""
    if not isinstance(keys, torch.Tensor) or keys.dim() != 2 or keys.shape[0] < 1:
        raise ValueError("keys must be a (K, n) tensor with K >= 1")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if keys.shape[1] >= MAX_WIDTH:
        raise ValueError("sort width must be below 2^30")
    return keys


def _padded_width(n: int, tile: int) -> int:
    return max(1, -(-n // tile)) * tile


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, not {t.device}")


# ---------------------------------------------------------------- plain twins


def _stable_reorder(perm: torch.Tensor, cols) -> torch.Tensor:
    """``perm`` reordered stably by ``cols`` (element-indexed, most
    significant first): one stable sort per column, last column first."""
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    return perm


def _tile_cols(keys: torch.Tensor, n_pad: int, group: int):
    """Sort columns for the tile/merge twins: group id, then padding last,
    then the keys (padding reads zeros it never compares on)."""
    K, n = keys.shape
    ids = torch.arange(n_pad, device=keys.device)
    padded = torch.cat([keys, keys.new_zeros((K, n_pad - n))], dim=1)
    return [ids // group, (ids >= n).to(torch.int32), *padded]


def sort_tiles_ref(keys: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Plain twin of K1: each ``tile`` of indices sorted by (keys..., index)."""
    keys = _key_matrix(keys)
    n_pad = _padded_width(keys.shape[1], tile)
    perm = torch.arange(n_pad, device=keys.device)
    return _stable_reorder(perm, _tile_cols(keys, n_pad, tile)).to(torch.int32)


def merge_level_ref(keys: torch.Tensor, perm: torch.Tensor, run: int) -> torch.Tensor:
    """Plain twin of K2: stable merge of each pair of sorted ``run``-runs."""
    keys = _key_matrix(keys)
    cols = _tile_cols(keys, perm.shape[0], 2 * run)
    return _stable_reorder(perm.long(), cols).to(torch.int32)


def sort_operands_ref(keys, payloads=()) -> list:
    """Plain twin of ``sort_operands``: stable lexicographic sort."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    perm = _stable_reorder(perm, keys)
    return [k[perm] for k in keys] + [p[perm] for p in payloads]


# ---------------------------------------------------------------- kernels


def sort_tiles(keys: torch.Tensor) -> torch.Tensor:
    """K1: the index permutation (length n rounded up to ``TILE``) in which
    every tile of indices is sorted by (keys..., index)."""
    keys = _key_matrix(keys)
    if keys.device.type == "cpu":
        return sort_tiles_ref(keys)
    _require_cuda(keys, "sort_tiles")
    from ._build import load_library

    lib = load_library()
    K, n = keys.shape
    n_pad = _padded_width(n, TILE)
    perm = torch.empty(n_pad, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.archon_sort_tiles(keys.data_ptr(), n, K, perm.data_ptr(), n_pad, stream)
    _launch_check(rc, "sort_tiles")
    sort_tiles.launches += 1
    return perm


def merge_level(keys: torch.Tensor, perm: torch.Tensor, run: int) -> torch.Tensor:
    """K2: merge each pair of sorted ``run``-runs of ``perm`` (as left by
    ``sort_tiles`` or a previous level) into one sorted run of 2*run."""
    keys = _key_matrix(keys)
    if perm.dim() != 1 or perm.dtype != torch.int32 or not perm.is_contiguous():
        raise ValueError("perm must be a contiguous 1-D int32 tensor")
    if perm.device != keys.device:
        raise ValueError("keys and perm must be on one device")
    if perm.shape[0] < keys.shape[1] or run < 1:
        raise ValueError("perm must cover every key column and run must be >= 1")
    if keys.device.type == "cpu":
        return merge_level_ref(keys, perm, run)
    _require_cuda(keys, "merge_level")
    from ._build import load_library

    lib = load_library()
    K, n = keys.shape
    out = torch.empty_like(perm)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.archon_merge_level(
            keys.data_ptr(), n, K, perm.data_ptr(), out.data_ptr(), perm.shape[0], run, stream
        )
    _launch_check(rc, "merge_level")
    merge_level.launches += 1
    return out


sort_tiles.launches = 0
merge_level.launches = 0


def sort_operands(keys, payloads=()) -> list:
    """Stable sort of equal-length 1-D operands, lexicographic on ``keys``
    (int32), with ``payloads`` (any dtype) permuted along.  Returns the
    sorted keys then the sorted payloads, like ``lax.sort(keys + payloads,
    num_keys=len(keys))``."""
    keys, payloads = list(keys), list(payloads)
    if not keys:
        raise ValueError("sort_operands needs at least one key")
    n, dev = keys[0].shape[0], keys[0].device
    for t in keys + payloads:
        if t.dim() != 1 or t.shape[0] != n or t.device != dev:
            raise ValueError("operands must be 1-D, of one length, on one device")
    for k in keys:
        if k.dtype != torch.int32:
            raise TypeError(f"keys must be int32, got {k.dtype}")
    if dev.type == "cpu":
        return sort_operands_ref(keys, payloads)
    mat = torch.stack(keys)
    perm = sort_tiles(mat)
    run = TILE
    while run < perm.shape[0]:
        perm = merge_level(mat, perm, run)
        run *= 2
    perm = perm[:n]
    return [k[perm] for k in keys] + [p[perm] for p in payloads]
