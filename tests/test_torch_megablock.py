"""The port's sharded megablock (``archon_tpu_torch/parallel/megablock.py``)
against the JAX package's programs on the 8-device CPU mesh and against the
golden model: the same seeded bytes through both, integers compared exactly
(tolerance 0).  The port runs its 8 shards in process on the CPU (a mesh of
eight entries of ``cpu``: the sorts take their plain twins), and once as two
spawned ranks of a gloo group."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from archon_tpu.golden import sa as golden
from archon_tpu.parallel import megablock as jmb
from archon_tpu.parallel.blocks import make_mesh as jax_mesh
from archon_tpu.utils.corpus import gauntlet_cases, text_like
from archon_tpu_torch.ops import sort as tsort
from archon_tpu_torch.parallel import megablock as mb
from archon_tpu_torch.parallel.blocks import make_mesh
from archon_tpu_torch.parallel.collectives import InProcess, collectives, spawn

NS, N = 8, 2048
S = N // NS
KS = (3, 12, 48, 192, 768)


def _mesh(ns=NS):
    return make_mesh({"sp": ns}, devices=["cpu"] * ns)


def _text(seed=13):
    return np.frombuffer(text_like(N, seed=seed), np.uint8)


@pytest.mark.parametrize("ns", [1, 2, 4, 8, 16])
def test_network_specs_equal_the_jax_lists(ns):
    assert mb._bitonic_stages(ns) == jmb._bitonic_stages(ns)
    for m in (1, 2, 4):
        if m < ns:
            assert mb._pairs(ns, m) == jmb._pairs(ns, m)
    for d in (-1, 0, 1, 3, ns - 1):
        assert mb._rot(ns, d) == jmb._rot(ns, d)


@pytest.mark.parametrize("ns", [2, 8])
@pytest.mark.parametrize("width", [64, tsort.MERGE_TILE], ids=["ragged", "aligned"])
def test_merge_split_sort_is_a_global_stable_sort(ns, width):
    """(keys..., pos) with many ties in the keys, and a payload; at a shard
    size whose stages pad their runs and at one whose stages need no pad."""
    n = ns * width
    rng = np.random.default_rng(ns)
    keys = [rng.integers(0, 3, n).astype(np.int32) for _ in range(2)]
    pos = rng.permutation(n).astype(np.int32)
    pay = rng.integers(0, 256, n, dtype=np.uint8)
    coll = collectives(_mesh(ns), "sp")
    assert isinstance(coll, InProcess)
    arrays = [coll.shard(torch.from_numpy(a)) for a in (*keys, pos, pay)]
    got = mb._merge_split_sort(arrays, 3, ns, coll.axis_index(), coll)
    order = np.lexsort((pos, keys[1], keys[0]))
    for g, a in zip(got, (*keys, pos, pay)):
        assert g.reshape(-1).numpy().tolist() == a[order].tolist()


@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dynamic"])
def test_halo_windows_are_slices_of_the_global_rank(dyn):
    coll = collectives(_mesh(), "sp")
    rank = torch.from_numpy(np.random.default_rng(5).permutation(N).astype(np.int32))
    window = mb._halo_window_dyn if dyn else mb._halo_window
    for k in KS:
        for j in (1, 2, 3):
            if j * k >= N:
                continue
            got = window(coll.shard(rank), j * k, S, NS, coll).reshape(-1)
            valid = N - j * k  # positions past n are garbage, masked by the caller
            assert torch.equal(got[:valid], rank[j * k :])


@pytest.fixture(scope="module")
def jax_programs():
    """The JAX programs' outputs on one text, a4 and a7: the init, every
    round (k-dynamic program; the static one at the first and last k), the
    resolved ranks and the emit."""
    mesh = jax_mesh({"sp": NS})
    arr = _text()
    data_dev = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("sp")))
    out = {}
    for sentinel in ("small", "large"):
        rank, na = jmb._make_init(mesh, S, N, sentinel)(data_dev)
        rec = {"init": (np.asarray(rank), int(na)), "rounds": [], "static": {}}
        dyn = jmb._make_round_dyn(mesh, S, N, sentinel)
        for k in KS:
            if sentinel == "small" and k in (KS[0], KS[-1]):
                r, a = jmb._make_round(mesh, S, N, k, sentinel)(rank)
                rec["static"][k] = (np.asarray(r), int(a))
            rank, na = dyn(rank, jnp.int32(k))
            rec["rounds"].append((np.asarray(rank), int(na)))
        final, _, _, _ = jmb._sharded_ranks(arr, mesh, sentinel)
        L, base = jmb._make_emit(mesh, S, N)(final, data_dev)
        rec["final"] = np.asarray(final)
        rec["emit"] = (np.asarray(L), int(base))
        out[sentinel] = rec
    return out


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_init_rounds_and_emit_equal_the_jax_programs(jax_programs, sentinel):
    """Every (rank, nactive) that ``_slot_ranks`` returns, from the init and
    from each round under both names, and the emit's (L, base)."""
    want = jax_programs[sentinel]
    mesh = _mesh()
    coll = collectives(mesh, "sp")
    data = coll.shard(torch.from_numpy(_text().copy()))
    rank, na = mb._make_init(mesh, S, N, sentinel)(data)
    assert rank.dtype == torch.int32 and na.dtype == torch.int32
    assert (rank.reshape(-1).numpy().tolist(), int(na)) == (want["init"][0].tolist(), want["init"][1])
    dyn = mb._make_round_dyn(mesh, S, N, sentinel)
    for k, (want_rank, want_na) in zip(KS, want["rounds"]):
        static_rank, static_na = mb._make_round(mesh, S, N, k, sentinel)(rank)
        rank, na = dyn(rank, k)
        assert rank.dtype == torch.int32 and rank.shape == (NS, S)
        assert torch.equal(static_rank, rank) and int(static_na) == int(na)
        assert (rank.reshape(-1).numpy().tolist(), int(na)) == (want_rank.tolist(), want_na)
        if k in want["static"]:
            assert want["static"][k][0].tolist() == want_rank.tolist()
    final, data_dev, s, n = mb._sharded_ranks(_text(), mesh, sentinel)
    assert (s, n) == (S, N) and final.reshape(-1).numpy().tolist() == want["final"].tolist()
    L, base = mb._make_emit(mesh, S, N)(final, data_dev)
    assert L.dtype == torch.uint8
    assert (L.reshape(-1).numpy().tolist(), int(base)) == (want["emit"][0].tolist(), want["emit"][1])


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_sharded_matches_golden(sentinel):
    mesh = _mesh()
    rng = np.random.default_rng(17)
    cases = [
        np.frombuffer(text_like(4096), np.uint8),
        rng.integers(0, 4, 2048, dtype=np.uint8),
        rng.integers(0, 256, 4096, dtype=np.uint8),
        np.frombuffer(gauntlet_cases(2048)["fibonacci"], np.uint8),
        np.zeros(2048, np.uint8),  # one tie group spanning every shard
    ]
    for arr in cases:
        want = golden.suffix_array(arr, sentinel)
        got = mb.suffix_array_sharded(arr, mesh, sentinel)
        assert got.dtype == np.int32 and got.tolist() == want.tolist(), f"{sentinel} n={len(arr)}"


def test_sharded_two_shards():
    arr = np.frombuffer(text_like(1 << 10, seed=3), np.uint8)
    got = mb.suffix_array_sharded(arr, _mesh(2), "small")
    assert got.tolist() == golden.suffix_array(arr, "small").tolist()


def test_sharded_bwt_emission():
    mesh = _mesh()
    for arr in (np.frombuffer(text_like(4096, seed=5), np.uint8), np.zeros(2048, np.uint8)):
        L, base = mb.bwt_megablock(arr, mesh, "small")
        want_L, want_base = golden.bwt_forward(arr, "small")
        assert L.shape == (NS, len(arr) // NS)
        assert L.reshape(-1).numpy().tolist() == want_L.tolist()
        assert base == int(want_base)


def test_merge_level_stages_equal_the_resort_stages(monkeypatch):
    """At a ragged shard size (S = 1064, so each stage pads both runs to
    1024 columns more): every stage as one merge level in the kernels'
    layout (``_merge_rows_kernels``, on K2's twin) gives the same suffix
    array as with every stage re-sorted by ``sort_rows``, and the golden
    model's; and the loop counts its rounds and host reads (one read after
    the init and one after each round: no round runs past resolution)."""
    S_ragged = 1064
    arr = np.frombuffer(text_like(2 * S_ragged, seed=8), np.uint8)
    mesh = _mesh(2)
    monkeypatch.setattr(mb, "merge_rows", tsort._merge_rows_kernels)
    calls, pad = tsort.merge_rows.calls, tsort.merge_rows.pad
    mb.stats.reset()
    got = mb.suffix_array_sharded(arr, mesh, "large")
    staged = tsort.merge_rows.calls - calls
    assert staged >= 3 and mb.stats.host_syncs == mb.stats.rounds + 1 >= 2
    assert tsort.merge_rows.pad - pad == staged * 2 * 2 * (2048 - S_ragged)
    monkeypatch.setattr(mb, "_stage_merge", lambda both, nk: tsort.sort_rows(both[:nk], both[nk:]))
    assert got.tolist() == mb.suffix_array_sharded(arr, mesh, "large").tolist()
    assert tsort.merge_rows.calls - calls == staged
    assert got.tolist() == golden.suffix_array(arr, "large").tolist()


def _two_run_rows(rng, B, S, nk):
    """(keys, payloads) of B rows of two runs of S, each run sorted by the
    nk keys: keys 0..3 with many ties, a fifth key a permutation, and real
    all-0x7FFFFFFF tuples planted in both runs; one uint8 payload."""
    keys = [rng.integers(0, 3, (B, 2 * S)).astype(np.int32) for _ in range(min(nk, 4))]
    if nk == 5:
        keys.append(np.stack([rng.permutation(2 * S) for _ in range(B)]).astype(np.int32))
    for k in keys:
        k[:, 5::97] = tsort.PAD_KEY
        k[:, S + 3::89] = tsort.PAD_KEY
    keys = [torch.from_numpy(k) for k in keys]
    pay = torch.from_numpy(rng.integers(0, 256, (B, 2 * S), dtype=np.uint8))
    halves = [tsort.sort_rows_ref([k[:, h : h + S] for k in keys], [pay[:, h : h + S]])
              for h in (0, S)]
    both = [torch.cat([a, b], dim=1) for a, b in zip(*halves)]
    return both[:nk], both[nk:]


def _assert_runs_in_kernel_order(keys):
    """Each padded run of ``_merge_tuples``' buffer is sorted in K2's own
    order, which the twin does not share (it places padding last by its
    index alone): the carried keys, then for two real tuples the keys past
    the C-th and the index, for a padding tuple the index (``rest_less``)."""
    (B, w), nk = keys[0].shape, len(keys)
    n = B * w
    mat = torch.stack(keys).view(nk, n)
    tuples, Sp = tsort._merge_tuples(mat, B, w // 2)
    C = tuples.shape[0] - 1
    for run in tuples.view(C + 1, B * 2, Sp).permute(1, 0, 2).numpy().astype(np.int64):
        idx = run[C]
        real = idx < n
        rest = [np.where(real, mat[c].numpy().astype(np.int64)[np.minimum(idx, n - 1)], 1 << 40)
                for c in range(C, nk)]
        order = np.lexsort((idx, *reversed(rest), *reversed(list(run[:C]))))
        assert order.tolist() == list(range(Sp))
        assert real[: w // 2].all() and not real[w // 2 :].any()


@pytest.mark.parametrize("nk,S", [(5, tsort.MERGE_TILE), (5, 1500), (3, 1500), (1, 37)],
                         ids=["5keys-aligned", "5keys-ragged", "3keys-ragged", "1key-ragged"])
def test_merge_rows_layout_through_the_merge_level_twin(nk, S):
    """``merge_rows``' buffer layout (each run padded to a multiple of 1024
    columns, one K2 level at ``run`` = the padded run), driven through K2's
    twin on CPU tensors, against the stable sort of each row; with five keys
    one is read by index, and the planted all-0x7FFFFFFF tuples of both runs
    must come out before the padding."""
    keys, pay = _two_run_rows(np.random.default_rng(3), 4, S, nk)
    _assert_runs_in_kernel_order(keys)
    want = tsort.sort_rows_ref(keys, pay)
    got = tsort._merge_rows_kernels(keys, pay)
    assert all(g.shape == x.shape and torch.equal(g, x) for g, x in zip(got, want))
    assert all(torch.equal(g, x) for g, x in zip(tsort.merge_rows(keys, pay), want))


def test_merge_rows_counts_calls_and_padding(monkeypatch):
    """``merge_rows.calls`` grows by one a call through the kernels' layout
    and ``merge_rows.pad`` by the padding tuples it added: B * 2 * (S' - S),
    0 at a width that is a multiple of 2048.  The twin path on the CPU
    counts nothing, and a wrapper put in place of the global name (as the
    traced benchmark does) does not take the counts."""
    rng = np.random.default_rng(5)
    calls, pad = tsort.merge_rows.calls, tsort.merge_rows.pad
    tsort._merge_rows_kernels(*_two_run_rows(rng, 3, tsort.MERGE_TILE, 2))
    assert (tsort.merge_rows.calls - calls, tsort.merge_rows.pad - pad) == (1, 0)
    original = tsort.merge_rows
    monkeypatch.setattr(tsort, "merge_rows", lambda keys, payloads=(): original(keys, payloads))
    tsort._merge_rows_kernels(*_two_run_rows(rng, 3, 1100, 2))
    assert (original.calls - calls, original.pad - pad) == (2, 3 * 2 * (2048 - 1100))
    original(*_two_run_rows(rng, 3, 1100, 2))
    assert (original.calls - calls, original.pad - pad) == (2, 3 * 2 * (2048 - 1100))


def test_bad_shard_counts_raise():
    arr = np.zeros(2050, np.uint8)
    with pytest.raises(ValueError, match="n=2050 not divisible by 8 shards"):
        mb.suffix_array_sharded(arr, _mesh(8), "small")
    with pytest.raises(ValueError, match="shard count 6 must be a power of two"):
        mb.suffix_array_sharded(arr[:2046], _mesh(6), "small")
    with pytest.raises(ValueError, match="distinct devices"):
        collectives(make_mesh({"sp": 2}, devices=["cpu", "meta"]), "sp")


def test_gloo_ranks_give_the_in_process_suffix_array():
    """Two spawned ranks, one shard each, the collectives over gloo."""
    arr = np.frombuffer(text_like(1024, seed=3), np.uint8)
    got = spawn(mb._suffix_array_on_rank, 2, "gloo", arr, "cpu", "small")
    assert got.tolist() == mb.suffix_array_sharded(arr, _mesh(2), "small").tolist()
    assert got.tolist() == golden.suffix_array(arr, "small").tolist()


@pytest.mark.parametrize("name", ["zeros", "fibonacci"])
def test_sharded_gauntlet_large(name):
    """Shard-spanning tie groups at n = 2^20 (about ten seconds each here:
    every stage is one stable sort of rows that are two sorted runs)."""
    n = 1 << 20
    if name == "zeros":
        arr = np.zeros(n, np.uint8)
    else:
        arr = np.frombuffer(gauntlet_cases(n)["fibonacci"], np.uint8)[:n]
    got = mb.suffix_array_sharded(arr, _mesh(), "small")
    np.testing.assert_array_equal(got, golden.suffix_array(arr, "small"))
