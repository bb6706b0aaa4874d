"""Stable multi-key sort for the forward BWT: Hopper tile sort + merge levels.

Port of ``archon_tpu/ops/pallas_sort.py``.  Its two Pallas kernels become two
CUDA kernels in ``archon_tpu_torch/csrc/sort.cu`` (built by ``ops/_build.py``):

- ``sort_tiles`` (K1) replaces ``sort_tiles`` / ``_tile_sort_kernel``
  (``pallas_sort.py:393`` / ``:385``): one thread block sorts each
  ``TILE``-tuple tile in shared memory (a register sort per thread, then
  in-block merges);
- ``merge_level`` (K2) replaces ``_merge_level`` / ``_merge_kernel``
  (``pallas_sort.py:317`` / ``:265``): merged runs of L -> 2L, a split pass
  (``_merge_partition``, ``:211``) finding every block's merge-path split,
  then the merge.

``sort_operands`` drives K1 and then the K2 levels; it is the port's sort at
every 1-D ``lax.sort`` site of ``core/``.  ``sort_rows`` is its form for a
``(B, n)`` batch sorted along the last axis (``lax.sort(dimension=1)``, the
sites of ``core/batched.py``): the same two kernels, one launch per level for
all rows.  Like the TPU kernels, both kernels carry the key values through
the sort: a tuple buffer of shape ``(C + 1, n_pad)``, int32, holds the first
``C = min(K, MAX_CARRY)`` keys and then the element index.  Keys past the
first ``C`` (the micro tail's 13 and 49) stay in the ``(K, n)`` key matrix and
are read by index only where every carried key ties.  ``sort_operands``
returns the carried keys as they come out and gathers the rest, and the
payloads of any dtype, by the index row.

Order: tuples compare on (keys..., index).  The index is the implicit last
key, unique, so the order is total and equal to a stable sort by the keys
(``lax.sort`` is stable and the JAX pipeline relies on it).  Padding up to a
tile multiple carries index >= n and every carried key ``PAD_KEY``
(0x7FFFFFFF), so it sorts after every real element, a real all-0x7FFFFFFF
one included, and among itself by index.  Key values need no reserved
sentinel: 0x7FFFFFFF and -1 are real keys in core/fast2.

Each kernel has a plain PyTorch twin (``sort_tiles_ref``, ``merge_level_ref``:
the same tuples in and out, by stable ``torch.sort`` passes within each tile
or run pair; ``sort_operands_ref`` and ``sort_rows_ref``: stable passes from
the last key to the first, then gathers).  A wrapper takes its twin only for
tensors on the CPU; on a CUDA tensor it launches its kernel or raises.  To
inspect a path without the kernels, give it CPU tensors or call the twins.
``merge_rows`` is the one-level form for rows that are two sorted runs each
(the megablock's merge-split stages): K2 alone, once, each run padded to a
multiple of ``MERGE_TILE // 2`` the way ``sort_rows`` pads a row.
``sort_tiles.launches`` and ``merge_level.launches`` count kernel launches,
``sort_tiles.bytes`` and ``merge_level.bytes`` the bytes those launches need
(see ``sort_tiles`` and ``merge_level``).
"""

from __future__ import annotations

import torch

TILE = 8192  # K1's tile, kSortTile in csrc/sort.cu: 1024 threads x 8 elements
MERGE_TILE = 2048  # K2's outputs per block, kMergeTile in csrc/sort.cu
MAX_CARRY = 4  # keys carried in the tuples, kMaxCarry in csrc/sort.cu
PAD_KEY = 0x7FFFFFFF  # every carried key of a padding tuple
MAX_WIDTH = 1 << 30  # sort widths must stay below this (int32 indices, padding)


def carried(num_keys: int) -> int:
    """Keys a tuple carries for a sort on ``num_keys`` keys."""
    return min(num_keys, MAX_CARRY)


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


def _tuple_buffer(keys: torch.Tensor, tuples) -> torch.Tensor:
    """Validate a (C + 1, n_pad) tuple buffer for the key matrix ``keys``."""
    C = carried(keys.shape[0])
    if (not isinstance(tuples, torch.Tensor) or tuples.dim() != 2 or tuples.shape[0] != C + 1
            or tuples.dtype != torch.int32 or not tuples.is_contiguous()):
        raise ValueError(f"tuples must be a contiguous ({C + 1}, n_pad) int32 tensor")
    if tuples.device != keys.device:
        raise ValueError("keys and tuples must be on one device")
    if tuples.shape[1] < keys.shape[1]:
        raise ValueError("tuples must cover every key column")
    return tuples


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


def _sorted_in_groups(keys: torch.Tensor, tuples: torch.Tensor, group: int) -> torch.Tensor:
    """``tuples`` with each ``group``-run sorted by (keys..., index): padding
    (index >= n) last, by index; keys past the carried ones by index."""
    K, n = keys.shape
    C = tuples.shape[0] - 1
    idx = tuples[C].long()
    pos = torch.arange(tuples.shape[1], device=keys.device)
    real = idx < n
    rest = []
    if K > C and n > 0:
        rest = torch.where(real, keys[C:, idx.clamp(max=n - 1)], 0).unbind()
    cols = [pos // group, (~real).to(torch.int32), *tuples[:C], *rest, idx]
    return tuples[:, _stable_reorder(pos, cols)]


def sort_tiles_ref(keys: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Plain twin of K1: the (C + 1, n_pad) tuples with each ``tile`` sorted."""
    keys = _key_matrix(keys)
    K, n = keys.shape
    C = carried(K)
    n_pad = _padded_width(n, tile)
    tuples = torch.full((C + 1, n_pad), PAD_KEY, dtype=torch.int32, device=keys.device)
    tuples[:C, :n] = keys[:C]
    tuples[C] = torch.arange(n_pad, dtype=torch.int32, device=keys.device)
    return _sorted_in_groups(keys, tuples, tile)


def merge_level_ref(keys: torch.Tensor, tuples: torch.Tensor, run: int) -> torch.Tensor:
    """Plain twin of K2: each pair of sorted ``run``-runs of ``tuples``
    merged (here: each 2*run group re-sorted by stable passes)."""
    keys = _key_matrix(keys)
    return _sorted_in_groups(keys, _tuple_buffer(keys, tuples), 2 * run)


def sort_operands_ref(keys, payloads=()) -> list:
    """Plain twin of ``sort_operands``: stable lexicographic sort."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    perm = _stable_reorder(perm, keys)
    return [k[perm] for k in keys] + [p[perm] for p in payloads]


# ---------------------------------------------------------------- kernels


def sort_tiles(keys: torch.Tensor, real: int | None = None) -> torch.Tensor:
    """K1: the (C + 1, n_pad) tuple buffer of the (K, n) key matrix, n_pad a
    multiple of ``TILE``, with every tile sorted by (keys..., index).

    A launch adds to ``sort_tiles.bytes`` what its ``real`` elements need (the
    caller's operands, ``n`` by default; padding columns are not counted):
    ``4 * (2C + 1)`` bytes each, the C carried keys read once and the (C + 1)
    tuple words written once.  Keys past the C-th are read only where every
    carried key ties; that depends on the data and is not counted."""
    keys = _key_matrix(keys)
    if keys.device.type == "cpu":
        return sort_tiles_ref(keys)
    _require_cuda(keys, "sort_tiles")
    from ._build import load_library

    lib = load_library()
    K, n = keys.shape
    C = carried(K)
    n_pad = _padded_width(n, TILE)
    out = torch.empty((C + 1, n_pad), dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.archon_sort_tiles(keys.data_ptr(), n, K, C, out.data_ptr(), n_pad, stream)
    _launch_check(rc, "sort_tiles")
    sort_tiles.launches += 1
    sort_tiles.bytes += 4 * (2 * C + 1) * (n if real is None else real)
    return out


def merge_level(keys: torch.Tensor, tuples: torch.Tensor, run: int,
                real: int | None = None) -> torch.Tensor:
    """K2: merge each pair of sorted ``run``-runs of the tuple buffer (as
    left by ``sort_tiles`` or a previous level) into one sorted run of
    2*run.  On CUDA, ``2 * run`` and n_pad are multiples of ``MERGE_TILE``
    (as ``sort_operands`` gives them).

    A launch adds to ``merge_level.bytes`` what its ``real`` elements need
    (``n`` by default, as in ``sort_tiles``): ``2 * 4 * (C + 1)`` bytes each,
    the tuple read once and written once.  The split pass and the keys past
    the C-th, read on ties, are not counted."""
    keys = _key_matrix(keys)
    tuples = _tuple_buffer(keys, tuples)
    if run < 1:
        raise ValueError("run must be >= 1")
    if keys.device.type == "cpu":
        return merge_level_ref(keys, tuples, run)
    _require_cuda(keys, "merge_level")
    from ._build import load_library

    lib = load_library()
    K, n = keys.shape
    out = torch.empty_like(tuples)
    splits = torch.empty(tuples.shape[1] // MERGE_TILE, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.archon_merge_level(keys.data_ptr(), n, K, carried(K), tuples.data_ptr(),
                                    out.data_ptr(), splits.data_ptr(), tuples.shape[1], run,
                                    stream)
    _launch_check(rc, "merge_level")
    merge_level.launches += 1
    merge_level.bytes += 2 * 4 * (carried(K) + 1) * (n if real is None else real)
    return out


sort_tiles.launches = 0
merge_level.launches = 0
sort_tiles.bytes = 0  # bytes the launches' real elements need, since import
merge_level.bytes = 0


def sort_operands(keys, payloads=()) -> list:
    """Stable sort of equal-length 1-D operands, lexicographic on ``keys``
    (int32), with ``payloads`` (any dtype) permuted along.  Returns the
    sorted keys then the sorted payloads, like ``lax.sort(keys + payloads,
    num_keys=len(keys))``.  On CUDA the first ``MAX_CARRY`` sorted keys are
    views of the kernels' tuple buffer."""
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
    tuples = _sort_runs(torch.stack(keys), n, n)
    C = tuples.shape[0] - 1
    perm = tuples[C, :n]
    return ([tuples[c, :n] for c in range(C)] + [k[perm] for k in keys[C:]]
            + [p[perm] for p in payloads])


def _sort_runs(mat: torch.Tensor, width: int, real: int) -> torch.Tensor:
    """K1 over the (K, m) key matrix on a CUDA device, then K2 levels until
    the sorted runs reach ``width``: the tuple buffer with every aligned
    ``width``-run sorted (the whole of it when ``width >= m``).  ``real`` is
    the count of the caller's elements among the m columns."""
    tuples = sort_tiles(mat, real)
    run = TILE
    while run < min(width, tuples.shape[1]):
        tuples = merge_level(mat, tuples, run, real)
        run *= 2
    return tuples


def row_width(B: int, n: int) -> int:
    """Columns each row takes in ``sort_rows``' tuple buffer: ``TILE * 2^m``
    when rows share a buffer, so that K2's aligned run pairs stop at the row
    and no merge crosses into the next; a lone row pads to a tile multiple."""
    if B == 1:
        return _padded_width(n, TILE)
    w = TILE
    while w < n:
        w *= 2
    return w


def sort_rows_ref(keys, payloads=()) -> list:
    """Plain twin of ``sort_rows``: stable ``torch.sort`` passes along
    ``dim=1``, last key first, then gathers."""
    B, n = keys[0].shape
    perm = torch.arange(n, device=keys[0].device).expand(B, n)
    for c in reversed(keys):
        perm = perm.gather(1, torch.sort(c.gather(1, perm), dim=1, stable=True).indices)
    return [t.gather(1, perm) for t in (*keys, *payloads)]


def sort_rows(keys, payloads=()) -> list:
    """Stable sort of equal-shape (B, n) operands along the last axis, each
    row on its own, lexicographic on ``keys`` (int32), with ``payloads`` (any
    dtype) permuted along: ``lax.sort(keys + payloads, dimension=1,
    num_keys=len(keys))``.

    On CUDA the rows are laid end to end in one key matrix, each padded to
    ``row_width`` columns with ``PAD_KEY`` in every key, and sorted by one K1
    launch and one K2 launch per level for the whole batch; the levels stop
    at the row width.  Padding of a row follows its real elements in index
    order and ties with nothing below it, so it sorts to the row's end."""
    keys, payloads = list(keys), list(payloads)
    if not keys:
        raise ValueError("sort_rows needs at least one key")
    shape, dev = keys[0].shape, keys[0].device
    for t in keys + payloads:
        if t.dim() != 2 or t.shape != shape or t.device != dev:
            raise ValueError("operands must be 2-D, of one shape, on one device")
    for k in keys:
        if k.dtype != torch.int32:
            raise TypeError(f"keys must be int32, got {k.dtype}")
    if dev.type == "cpu":
        return sort_rows_ref(keys, payloads)
    if shape[0] == 0 or shape[1] == 0:
        return keys + payloads
    return _sort_rows_kernels(keys, payloads)


def _sort_rows_kernels(keys: list, payloads: list) -> list:
    """``sort_rows`` through K1 and K2 (on CPU tensors, through their twins:
    the tests hold the row layout that way)."""
    (B, n), dev = keys[0].shape, keys[0].device
    W = row_width(B, n)
    if B * W >= MAX_WIDTH:
        raise ValueError("sort_rows: the batch's padded width must be below 2^30")
    if W == n:
        mat = torch.stack(keys).view(len(keys), B * n)
    else:
        mat = torch.full((len(keys), B, W), PAD_KEY, dtype=torch.int32, device=dev)
        for j, k in enumerate(keys):
            mat[j, :, :n] = k
        mat = mat.view(len(keys), B * W)
    tuples = _sort_runs(mat, W, B * n).view(-1, B, W)
    C = tuples.shape[0] - 1
    # buffer index of (row b, column j) is b * W + j: the operands' is b * n + j
    rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    perm = tuples[C, :, :n] - rows * (W - n)
    return ([tuples[c, :, :n] for c in range(C)] + [k.reshape(-1)[perm] for k in keys[C:]]
            + [p.reshape(-1)[perm] for p in payloads])


def merge_rows(keys, payloads=()) -> list:
    """``sort_rows`` for (B, 2S) operands whose rows are each two runs of S
    already sorted by ``keys``: the same result (a merge of sorted runs by
    (keys..., index) is the stable sort of the row) by ONE K2 level for all
    rows and no K1, at any S.  The sharded megablock's merge-split stages are
    this shape: ``[mine, partner]``, both sorted.  Rows that are not two
    sorted runs come out unsorted, unchecked.

    ``merge_rows.calls`` counts the calls that reach the kernels' layout and
    ``merge_rows.pad`` the padding tuples they added (see
    ``_merge_tuples``)."""
    keys, payloads = list(keys), list(payloads)
    if not keys:
        raise ValueError("merge_rows needs at least one key")
    shape, dev = keys[0].shape, keys[0].device
    for t in keys + payloads:
        if t.dim() != 2 or t.shape != shape or t.device != dev:
            raise ValueError("operands must be 2-D, of one shape, on one device")
    for k in keys:
        if k.dtype != torch.int32:
            raise TypeError(f"keys must be int32, got {k.dtype}")
    if shape[1] % 2:
        raise ValueError("merge_rows: a row is two runs of one length")
    if dev.type == "cpu":
        return sort_rows_ref(keys, payloads)
    if shape[0] == 0 or shape[1] == 0:
        return keys + payloads
    return _merge_rows_kernels(keys, payloads)


merge_rows.calls = 0
merge_rows.pad = 0
# bumped through the function's own attribute dict, not its global name: the
# traced benchmark puts a wrapper, which has no counters, in place of that name
_merge_rows_counts = merge_rows.__dict__


def _merge_tuples(mat: torch.Tensor, B: int, S: int) -> tuple[torch.Tensor, int]:
    """The (C + 1, B * 2 * S') tuple buffer of the (K, B * 2S) key matrix of
    rows ``[run_0, run_1]``, and S'.  Each run takes S' = S rounded up to a
    multiple of ``MERGE_TILE // 2`` columns, so that K2's run pairs (run S')
    are the rows: layout (C + 1, B, 2, S').  A real tuple carries its column
    in ``mat`` as its index; each run's S' - S padding tuples carry
    ``PAD_KEY`` in every key and indices from B * 2S up, ascending, so each
    padded run stays sorted and the first 2S outputs of a merged row are its
    real tuples."""
    C = carried(mat.shape[0])
    dev = mat.device
    Sp = _padded_width(S, MERGE_TILE // 2)
    pad = Sp - S
    if B * 2 * Sp >= MAX_WIDTH:
        raise ValueError("merge_rows: the batch's padded width must be below 2^30")
    tuples = torch.empty((C + 1, B, 2, Sp), dtype=torch.int32, device=dev)
    tuples[:C, :, :, :S] = mat[:C].view(C, B, 2, S)
    # index of (row b, run h, column j): (2b + h) * S + j, one pass into the strided view
    torch.add(torch.arange(0, B * 2 * S, S, dtype=torch.int32, device=dev).view(B, 2, 1),
              torch.arange(S, dtype=torch.int32, device=dev), out=tuples[C, :, :, :S])
    if pad:
        tuples[:C, :, :, S:] = PAD_KEY
        tuples[C, :, :, S:] = torch.arange(B * 2 * S, B * 2 * Sp, dtype=torch.int32,
                                           device=dev).view(B, 2, pad)
    return tuples.view(C + 1, B * 2 * Sp), Sp


def _merge_rows_kernels(keys: list, payloads: list) -> list:
    """``merge_rows`` through K2 (on CPU tensors, through its twin: the tests
    hold the layout that way)."""
    B, w = keys[0].shape
    if B * w >= MAX_WIDTH:
        raise ValueError("merge_rows: the batch's width must be below 2^30")
    S = w // 2
    mat = torch.stack(keys).view(len(keys), B * w)
    tuples, Sp = _merge_tuples(mat, B, S)
    C = tuples.shape[0] - 1
    tuples = merge_level(mat, tuples, Sp).view(C + 1, B, 2 * Sp)[:, :, :w]
    _merge_rows_counts["calls"] += 1
    _merge_rows_counts["pad"] += B * 2 * (Sp - S)
    perm = tuples[C]  # a real tuple's index is its operand's column in mat
    return ([tuples[c] for c in range(C)] + [k.reshape(-1)[perm] for k in keys[C:]]
            + [p.reshape(-1)[perm] for p in payloads])
