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


def _twin_sort(mat, tile):
    """The kernels' path with their twins at a small tile: K1, then K2
    levels; returns the final (C + 1, n_pad) tuples."""
    tuples = tsort.sort_tiles_ref(mat, tile)
    run = tile
    while run < tuples.shape[1]:
        tuples = tsort.merge_level_ref(mat, tuples, run)
        run *= 2
    return tuples


def _check_tuples(tuples, keys, n):
    """Final tuples against lax.sort of (keys..., iota): every carried row and
    the index row; padding last, in index order, keys 0x7FFFFFFF."""
    C = tuples.shape[0] - 1
    iota = np.arange(n, dtype=np.int32)
    want = lax.sort(tuple(jnp.asarray(x) for x in (*keys, iota)), num_keys=len(keys))
    got = tuples.numpy()
    for c in range(C):
        assert np.array_equal(got[c, :n], np.asarray(want[c]))
    assert np.array_equal(got[C, :n], np.asarray(want[-1]))
    assert np.array_equal(got[C, n:], np.arange(n, got.shape[1]))
    assert (got[:C, n:] == tsort.PAD_KEY).all()


def test_sort_tiles_ref_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    n = 4 * TILE
    key = rng.integers(0, 1000, n).astype(np.int32)
    iota = np.arange(n, dtype=np.int32)
    want = jsort.sort_tiles((jnp.asarray(key), jnp.asarray(iota)), num_keys=2,
                            tile=TILE, interpret=True)
    mat = _t(key[None])
    got = tsort.sort_tiles_ref(mat, TILE)
    assert got.shape == (2, n)
    for g, w in zip(got.numpy(), want):  # the carried key row and the index row
        assert np.array_equal(g, np.asarray(w))
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
    tuples = tsort.sort_tiles_ref(mat, TILE)
    got = tsort.merge_level_ref(mat, tuples, TILE)
    # the key row whole (Pallas pads with INF = PAD_KEY), the index row on
    # the real elements (Pallas pads its iota with INF, the twin with n..)
    assert np.array_equal(got.numpy()[0], np.asarray(want[0]))
    assert np.array_equal(got.numpy()[1, :n], np.asarray(want[1])[:n])
    assert np.array_equal(tsort.merge_level(mat, tuples, TILE).numpy(), got.numpy())
    # padding stays behind every real element, in index order
    assert np.array_equal(got.numpy()[1, n:], np.arange(n, n_pad))


def test_twins_carry_four_of_six_keys():
    """K > C: the tuples carry 4 keys, keys 5 and 6 are read by index on
    ties; the twin path against lax.sort on every row."""
    rng = np.random.default_rng(6)
    n = 5 * TILE + 33
    keys = [rng.integers(0, 2, n).astype(np.int32) for _ in range(6)]
    mat = _t(np.stack(keys))
    tuples = _twin_sort(mat, TILE)
    assert tuples.shape == (tsort.MAX_CARRY + 1, 6 * TILE)
    _check_tuples(tuples, keys, n)
    got = tsort.sort_operands([_t(k) for k in keys])
    want = lax.sort(tuple(jnp.asarray(k) for k in keys), num_keys=6)
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("nk", [1, 3, 6])
def test_twins_real_max_keys_sort_before_padding(nk):
    """A ragged width whose real elements have every key 0x7FFFFFFF, as
    padding does: they stay ahead of it, by index."""
    rng = np.random.default_rng(nk)
    n = 2 * TILE + 45
    keys = [rng.choice(np.array([-1, 0x7FFFFFFF], np.int32), n) for _ in range(nk)]
    for k in keys:
        k[::3] = 0x7FFFFFFF
    tuples = _twin_sort(_t(np.stack(keys)), TILE)
    _check_tuples(tuples, keys, n)
    C = tuples.shape[0] - 1
    all_max = np.flatnonzero(np.all(np.stack(keys) == 0x7FFFFFFF, axis=0))
    assert all_max.size and np.array_equal(tuples.numpy()[C, n - all_max.size:n], all_max)


def test_sort_operands_trigram_keys_of_text():
    """The bootstrap sort of the forward BWT on text: four packed-trigram
    keys (many ties past key 0) + the index, the sort and the twin path
    against lax.sort of the same operands."""
    from archon_tpu.utils.corpus import text_like
    from archon_tpu_torch.core import fast2

    data = torch.from_numpy(np.frombuffer(text_like(3 * TILE + 5, 11), np.uint8).copy())
    n = data.shape[0]
    p27 = fast2._trigram_keys(data, "small")
    keys = [p27[3 * j:3 * j + n].contiguous() for j in range(4)]
    iota = torch.arange(n, dtype=torch.int32)
    prev = torch.roll(data, 1)
    got = tsort.sort_operands(keys, [iota, prev])
    want = lax.sort(tuple(jnp.asarray(x.numpy()) for x in (*keys, iota, prev)), num_keys=4)
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
    _check_tuples(_twin_sort(torch.stack(keys), TILE), [k.numpy() for k in keys], n)


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
    tuples = _twin_sort(_t(np.stack(keys)), 1024)
    assert np.array_equal(tuples[-1].numpy(), order)
    for g, k in zip(tuples[:-1], keys):
        assert np.array_equal(g.numpy(), k[order])


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


ROW_SHAPES = {  # name -> (B, n, number of keys, key range)
    "one_row": (1, 1000, 2, 5),
    "ragged_three_rows": (3, 20_011, 2, 7),
    "thirteen_keys": (4, 333, 13, 2),
    "one_key_many_ties": (5, 4096, 1, 2),
    "tile_multiple": (2, 8192, 4, 3),
}


def _row_operands(name):
    B, n, nk, hi = ROW_SHAPES[name]
    rng = np.random.default_rng(len(name) + n)
    keys = [rng.integers(-1, hi, (B, n)).astype(np.int32) for _ in range(nk)]
    keys[0][:, ::11] = 0x7FFFFFFF  # a real key equal to the padding key
    payloads = [rng.integers(0, 256, (B, n)).astype(np.uint8), rng.integers(0, 2, (B, n)) > 0,
                np.broadcast_to(np.arange(n, dtype=np.int32), (B, n)).copy()]
    return keys, payloads


@pytest.mark.parametrize("name", sorted(ROW_SHAPES))
def test_sort_rows_matches_lax_sort_dimension_1(name):
    """``sort_rows`` (on the CPU its plain twin) against the batched JAX
    sort, with uint8, bool and index payloads; stable, so every output
    matches exactly."""
    keys, payloads = _row_operands(name)
    want = lax.sort(tuple(map(jnp.asarray, keys + payloads)), num_keys=len(keys), dimension=1)
    got = tsort.sort_rows(list(map(_t, keys)), list(map(_t, payloads)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == _t(np.asarray(w)).dtype
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(ROW_SHAPES))
def test_sort_rows_kernel_layout_matches_twin(name):
    """The layout the CUDA path gives the kernels (rows end to end, each
    padded to ``row_width`` with the padding key, merge levels stopping at
    the row), driven on the CPU through K1's and K2's twins, equals the
    plain ``sort_rows_ref``: no run crosses a row and padding stays last."""
    keys, payloads = _row_operands(name)
    keys, payloads = list(map(_t, keys)), list(map(_t, payloads))
    got = tsort._sort_rows_kernels(keys, payloads)
    want = tsort.sort_rows_ref(keys, payloads)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    B, n = keys[0].shape
    W = tsort.row_width(B, n)
    assert W % tsort.TILE == 0 and W >= n
    assert B == 1 or (W // tsort.TILE) & (W // tsort.TILE - 1) == 0


def test_sort_rows_rejects_bad_operands():
    k = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tsort.sort_rows([])
    with pytest.raises(ValueError):
        tsort.sort_rows([k], [torch.zeros((2, 9), dtype=torch.int32)])
    with pytest.raises(ValueError):
        tsort.sort_rows([k[0]])
    with pytest.raises(TypeError):
        tsort.sort_rows([k.long()])
