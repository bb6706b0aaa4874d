"""Port's sort (archon_tpu_torch.ops.sort) vs the JAX Pallas sort and lax.sort.

On the CPU the wrappers run their plain twins; those are held here, exactly
(tolerance 0: integer outputs), against ``archon_tpu.ops.pallas_sort`` in
interpret mode at the shapes of tests/test_pallas_sort.py, against
``lax.sort`` (the JAX pipeline's real sort) and against ``np.lexsort``.  The
CUDA kernels against the same twins: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from archon_tpu.ops import pallas_sort as jsort
from archon_tpu_torch.ops import sort as tsort

TILE = 128


def _lexorder(keys):
    """Stable lexicographic order (the index as the last tie-break)."""
    n = len(keys[0])
    return np.lexsort([np.arange(n)] + list(keys)[::-1])


def _t(a):
    return torch.tensor(np.asarray(a))


SHAPES = {  # name -> (n, number of keys, key range, payload count)
    "single_tile": (TILE, 1, 50, 0),
    "one_level_payload": (2 * TILE, 1, 9, 1),
    "levels_4T": (4 * TILE, 1, 1 << 20, 1),
    "ragged_3T+17": (3 * TILE + 17, 1, 1 << 20, 1),
    "ragged_5T-1": (5 * TILE - 1, 1, 1 << 20, 1),
    "ragged_T+1": (TILE + 1, 1, 1 << 20, 1),
    "three_keys": (2 * TILE + 100, 2, 4, 1),
    "five_keys_quad_round": (3 * TILE + 57, 4, 6, 0),
    "all_equal": (2 * TILE, 1, 1, 0),
    "descending": (4 * TILE, 1, None, 0),
}
# Pallas interpret mode costs seconds per shape: it runs on the shapes that
# cover one tile, one merge level and a ragged tail; every shape runs
# against lax.sort (the sort the JAX pipeline really calls) and np.lexsort.
PALLAS = ("single_tile", "one_level_payload", "ragged_T+1")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_sort_operands_ref_matches_jax(name):
    n, nk, hi, npay = SHAPES[name]
    rng = np.random.default_rng(len(name))
    if hi is None:
        keys = [np.arange(n, dtype=np.int32)[::-1].copy()]
    else:
        keys = [rng.integers(0, hi, n).astype(np.int32) for _ in range(nk)]
    pays = [rng.integers(-5000, 5000, n).astype(np.int32) for _ in range(npay)]
    iota = np.arange(n, dtype=np.int32)
    got = tsort.sort_operands([_t(k) for k in keys], [_t(iota)] + [_t(p) for p in pays])
    ops = tuple(jnp.asarray(x) for x in (*keys, iota, *pays))
    wants = [lax.sort(ops, num_keys=len(keys))]
    if name in PALLAS:
        wants.append(jsort.sort_operands(ops, num_keys=len(keys) + 1, tile=TILE,
                                         interpret=True))
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[len(keys)].numpy(), _lexorder(keys))


def test_sort_tiles_ref_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    n = 4 * TILE
    key = rng.integers(0, 1000, n).astype(np.int32)
    iota = np.arange(n, dtype=np.int32)
    _, want = jsort.sort_tiles((jnp.asarray(key), jnp.asarray(iota)), num_keys=2,
                               tile=TILE, interpret=True)
    mat = _t(key[None])
    got = tsort.sort_tiles_ref(mat, TILE)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the CPU wrapper is the twin at the kernel's own tile
    assert np.array_equal(tsort.sort_tiles(mat).numpy(), tsort.sort_tiles_ref(mat).numpy())


@pytest.mark.parametrize("n", [4 * TILE, 3 * TILE + 17])
def test_merge_level_ref_matches_pallas_interpret(n):
    """One merge level on the Pallas tile sort's output (runs of TILE)."""
    rng = np.random.default_rng(n)
    key = rng.integers(0, 7, n).astype(np.int32)
    n_pad = -(-n // TILE) * TILE
    pad = np.full(n_pad - n, jsort.INF, np.int32)
    ops = [jnp.asarray(np.concatenate([key, pad])),
           jnp.asarray(np.concatenate([np.arange(n, dtype=np.int32), pad]))]
    ops = jsort.sort_tiles(ops, num_keys=2, tile=TILE, interpret=True)
    want = jsort._merge_level(ops, 2, TILE, TILE, n_pad, interpret=True)
    mat = _t(key[None])
    perm = tsort.sort_tiles_ref(mat, TILE)
    got = tsort.merge_level_ref(mat, perm, TILE)
    assert np.array_equal(got.numpy()[:n], np.asarray(want[1])[:n])
    assert np.array_equal(tsort.merge_level(mat, perm, TILE).numpy(), got.numpy())
    # padding stays behind every real element, in index order
    assert np.array_equal(got.numpy()[n:], np.arange(n, n_pad))


def test_sort_operands_sentinel_keys_match_lax_sort():
    """-1 (the a4 off-end rank) and 0x7FFFFFFF (_BIG) are real key values
    on the main path: both sorts must order them as signed int32."""
    rng = np.random.default_rng(9)
    n = 1000
    vals = np.array([-1, 0, 5, 0x7FFFFFFF], np.int32)
    keys = [vals[rng.integers(0, 4, n)] for _ in range(2)]
    pay = rng.integers(0, 256, n).astype(np.uint8)
    want = lax.sort(tuple(jnp.asarray(x) for x in (*keys, pay)), num_keys=2)
    got = tsort.sort_operands([_t(k) for k in keys], [_t(pay)])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    order = _lexorder(keys)
    assert np.array_equal(got[2].numpy(), pay[order])


def test_sort_operands_fifty_keys():
    """The micro tail's width: 1 + 48 keys (+ the index) at 4096."""
    rng = np.random.default_rng(50)
    n = 4096
    keys = [rng.integers(0, 2, n).astype(np.int32) for _ in range(49)]
    keys[0][:] = rng.integers(0, 3, n)
    pos = rng.permutation(n).astype(np.int32)
    got = tsort.sort_operands([_t(k) for k in keys], [_t(pos)])
    order = _lexorder(keys)
    assert np.array_equal(got[-1].numpy(), pos[order])
    for g, k in zip(got[:-1], keys):
        assert np.array_equal(g.numpy(), k[order])
    mat = _t(np.stack(keys))
    perm = tsort.sort_tiles_ref(mat, 1024)
    run = 1024
    while run < n:
        perm = tsort.merge_level_ref(mat, perm, run)
        run *= 2
    assert np.array_equal(perm.numpy(), order)


def test_sort_operands_rejects_bad_operands():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tsort.sort_operands([k.long()])
    with pytest.raises(ValueError):
        tsort.sort_operands([k], [torch.zeros(7)])
    with pytest.raises(ValueError):
        tsort.sort_operands([])
    with pytest.raises(TypeError):
        tsort.sort_tiles(torch.zeros((1, 8), dtype=torch.int64))
    with pytest.raises(ValueError):
        tsort.sort_tiles(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsort.merge_level(torch.zeros((1, 8), dtype=torch.int32),
                          torch.zeros(8, dtype=torch.int64), 4)
