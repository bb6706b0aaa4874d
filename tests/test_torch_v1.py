"""The port's v1 suffix sorters (core/doubling, core/fast, core/bwt and the v1
half of core/batched) against the JAX package's.

Same numpy inputs through both packages on the CPU; every comparison is
exact (integer outputs, tolerance 0).  The stages of core/fast are held bit
for bit (rank and active count after ``_init`` and each ``_round_full``, the
compacted positions, rank / positions / count after each ``_round_active``),
each step fed the JAX state so that a difference shows where it arises.
Then the entry points end to end, against JAX and the golden model, for both
sentinels, on text, Gauntlet and fuzz inputs and the smallest sizes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import batched as jb
from archon_tpu.core import bwt as jbwt
from archon_tpu.core import doubling as jd
from archon_tpu.core import fast as jf
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases, text_like
from archon_tpu_torch.core import batched as tb
from archon_tpu_torch.core import bwt as tbwt
from archon_tpu_torch.core import doubling as td
from archon_tpu_torch.core import fast as tfa

SENTINELS = ["small", "large"]
N = 997  # the size of tests/test_fast_sa.py: one compiled shape per JAX function


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert np.array_equal(np.asarray(got), np.asarray(want)), what


def _planted(n, rep_len, alpha, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, alpha, n, dtype=np.uint8)
    base[100 : 100 + rep_len] = base[n // 2 : n // 2 + rep_len]
    return base


STAGE_INPUTS = {  # each keeps actives through the full rounds into the narrowed ones
    "periodic": lambda: np.frombuffer(b"abracadabra" * 300, np.uint8),
    "planted_binary": lambda: _planted(8192, 700, 2, 12),
    "nested": lambda: np.frombuffer(gauntlet_cases(4096)["nested"], np.uint8),
    "random": lambda: np.frombuffer(gauntlet_cases(4096)["random"], np.uint8),  # second stage only
}


@pytest.mark.parametrize("sentinel", SENTINELS)
@pytest.mark.parametrize("name", sorted(STAGE_INPUTS))
def test_fast_stages_match_jax(name, sentinel):
    arr = STAGE_INPUTS[name]()
    n = len(arr)
    rank, na = jf._init(jnp.asarray(arr), sentinel)
    got = tfa._init(_t(arr), sentinel)
    _same(got[0], rank, "init rank")
    assert got[1] == int(na)
    k, full = 3, 0
    while int(na) * 4 > n and int(na) > 0 and k < n:
        got = tfa._round_full(_t(rank), k, sentinel)
        rank, na = jf._round_full(rank, jnp.int32(k), sentinel)
        _same(got[0], rank, f"full round k={k} rank")
        assert got[1] == int(na), f"full round k={k} nactive"
        k, full = k * 4, full + 1
    assert int(na) > 0 and k < n, "the stage input must reach the narrowed rounds"
    active = 0
    for cap, stop_den in ((max(min(n, 4096), n // 4), 32), (max(min(n, 4096), n // 32), 0)):
        if int(na) == 0 or k >= n:
            break
        apos = jf._compact(rank, cap)
        _same(tfa._compact(_t(rank), cap), apos, f"compact cap={cap}")
        while (int(na) * stop_den > n if stop_den else int(na) > 0) and int(na) > 0 and k < n:
            got = tfa._round_active(_t(rank), _t(apos), k, sentinel)
            rank, apos, na = jf._round_active(rank, apos, jnp.int32(k), sentinel)
            for g, w, what in zip(got[:2], (rank, apos), ("rank", "apos")):
                _same(g, w, f"active round k={k} {what}")
            assert got[2] == int(na), f"active round k={k} nactive"
            k, active = k * 4, active + 1
    assert active > 0
    _same(tfa._finish(_t(rank)), jf._finish(rank), "finish")
    # the phases drive the same rounds
    rank0, na0 = tfa._init(_t(arr), sentinel)
    assert tfa._phase_full(rank0, 3, na0, sentinel, 4)[0] == 3 * 4 ** full


def _e2e_cases():
    rng = np.random.default_rng(99)
    cases = {"text": np.frombuffer(text_like(N), np.uint8)}
    for name, blob in gauntlet_cases(N).items():
        if len(blob) == N:
            cases[f"g_{name}"] = np.frombuffer(blob, np.uint8)
    for i in range(3):
        cases[f"fuzz{i}"] = rng.integers(0, int(rng.integers(2, 200)), N, dtype=np.uint8)
    cases["odd"] = rng.integers(0, 4, 777, dtype=np.uint8)
    for tiny in (b"a", b"ab", b"ba", b"aab", b"bab"):
        cases[f"tiny_{tiny.decode()}"] = np.frombuffer(tiny, np.uint8)
    return cases


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_suffix_arrays_match_jax_and_golden(sentinel):
    for name, arr in _e2e_cases().items():
        want = golden.suffix_array(arr, sentinel)
        _same(jd.suffix_array(jnp.asarray(arr), sentinel), want, f"jax {name}")
        _same(td.suffix_array(_t(arr), sentinel), want, f"doubling {name}")
        _same(tfa.suffix_array_fast(arr, sentinel, device="cpu"), want, f"fast {name}")
        _same(tfa.suffix_array_fused(_t(arr), sentinel),
              jf.suffix_array_fused(jnp.asarray(arr), sentinel), f"fused {name}")
        _same(tfa.suffix_ranks_fused(_t(arr), sentinel),
              jf.suffix_ranks_fused(jnp.asarray(arr), sentinel), f"ranks {name}")
        assert bool(tbwt.verify_sa(_t(arr), td.suffix_array(_t(arr), sentinel), sentinel))


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_bwt_forward_matches_jax_and_golden(sentinel):
    for name, arr in _e2e_cases().items():
        want_L, want_base = golden.bwt_forward(arr, sentinel)
        jL, jbase, jsa = jbwt.bwt_forward(jnp.asarray(arr), sentinel)
        L, base, sa = tbwt.bwt_forward(_t(arr), sentinel)
        _same(L, jL, f"bwt_forward L {name}")
        _same(sa, jsa, f"bwt_forward sa {name}")
        assert base == int(jbase) == int(want_base), name
        _same(L, want_L, f"golden L {name}")
        jL, jbase, jrank = jbwt.bwt_forward_fast(jnp.asarray(arr), sentinel)
        L, base, rank = tbwt.bwt_forward_fast(_t(arr), sentinel)
        _same(L, jL, f"bwt_forward_fast L {name}")
        _same(rank, jrank, f"bwt_forward_fast rank {name}")
        assert base == int(jbase) == int(want_base), name


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_smallest_sizes(n):
    """n = 0 is the port's own (the JAX emitters index an empty array); from
    n = 1 on both packages agree."""
    arr = np.frombuffer(b"bab"[:n], np.uint8)
    for sentinel in SENTINELS:
        want = golden.suffix_array(arr, sentinel)
        for sa in (td.suffix_array(_t(arr), sentinel),
                   tfa.suffix_array_fast(arr, sentinel, device="cpu"),
                   tfa.suffix_array_fast(_t(arr), sentinel, return_device=True)):
            _same(sa, want, f"n={n}")
        assert td.suffix_array(_t(arr), sentinel).dtype == torch.int32
        L, base, _ = tbwt.bwt_forward(_t(arr), sentinel)
        L2, base2, rank = tbwt.bwt_forward_fast(_t(arr), sentinel)
        assert L.tolist() == L2.tolist() and base == base2 and rank.shape == (n,)
        if n:
            want_L, want_base = golden.bwt_forward(arr, sentinel)
            assert L.tolist() == want_L.tolist() and base == int(want_base)
            _same(sa, jd.suffix_array(jnp.asarray(arr), sentinel), f"jax n={n}")
        _same(tb.suffix_ranks_batched(_t(arr)[None], sentinel)[0], np.argsort(want), f"batched {n}")
    assert td.num_doubling_rounds(n) == jd.num_doubling_rounds(n)


def test_doubling_helpers_match_jax():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, 600).astype(np.int32)
    rank, nuniq = td._dense_rank(_t(keys))
    jrank, jn = jd._dense_rank(jnp.asarray(keys))
    _same(rank, jrank, "dense rank")
    assert int(nuniq) == int(jn) == len(np.unique(keys)) and rank.dtype == torch.int32
    data = rng.integers(0, 256, 600, dtype=np.uint8)
    for sentinel in SENTINELS:
        rank, nuniq = td._initial_rank(_t(data), sentinel)
        jrank, jn = jd._initial_rank(jnp.asarray(data), sentinel)
        _same(rank, jrank, "initial rank")
        assert int(nuniq) == int(jn)
        n = len(data)
        off = -1 if sentinel == "small" else n + 1
        padded = np.concatenate([np.asarray(jrank), np.full(n, off, np.int32)])
        for k in (1, 7, 599, 600, 5000):
            want = jd._shifted_rank(jnp.asarray(padded), jnp.arange(n, dtype=jnp.int32), n,
                                    jnp.int32(k), jnp.int32(off))
            _same(td._shifted_rank(_t(padded), n, k), want, f"shift {k}")
    assert [td.num_doubling_rounds(n) for n in (1, 3, 4, 1000, 1 << 22)] == [
        jd.num_doubling_rounds(n) for n in (1, 3, 4, 1000, 1 << 22)]
    # a caller's sort_fn replaces the round's sort
    calls = []

    def sort_fn(*ops):
        calls.append(len(ops))
        return td.sort_operands(ops[:4], ops[4:])

    rep = np.frombuffer(b"abracadabra" * 20, np.uint8)
    _same(td.suffix_array(_t(rep), "small", sort_fn), golden.suffix_array(rep, "small"), "sort_fn")
    assert calls and set(calls) == {5}


def _batch():
    rows = [np.frombuffer(b, np.uint8) for b in gauntlet_cases(N).values() if len(b) == N]
    return np.stack([np.frombuffer(text_like(N, seed=4), np.uint8), *rows[:5]])


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_batched_v1_matches_jax(sentinel):
    data2 = _batch()
    j2 = jnp.asarray(data2)
    rank, na = jb._init2(j2, sentinel)
    got = tb._init2(_t(data2), sentinel)
    _same(got[0], rank, "init2 rank")
    _same(got[1], na, "init2 nactive")
    got = tb._round_full2(_t(rank), 3, sentinel)
    rank, na = jb._round_full2(rank, jnp.int32(3), sentinel)
    _same(got[0], rank, "round_full2 rank")
    _same(got[1], na, "round_full2 nactive")
    cap = max(min(N, 4096), N // 4)
    apos = jb._compact2(rank, N)  # some rows hold more than N/4 actives this early
    _same(tb._compact2(_t(rank), N), apos, "compact2")
    _same(tb._compact2(_t(rank), cap), jb._compact2(rank, cap), "compact2 cut")
    got = tb._round_active2(_t(rank), _t(apos), 12, sentinel)
    want = jb._round_active2(rank, apos, jnp.int32(12), sentinel)
    for g, w, what in zip(got, want, ("rank", "apos", "nactive")):
        _same(g, w, f"round_active2 {what}")

    jrank = jb.suffix_ranks_batched(j2, sentinel)
    _same(tb.suffix_ranks_batched(_t(data2), sentinel), jrank, "suffix_ranks_batched")
    for g, w, what in zip(tb.bwt_forward_batched(_t(data2), sentinel),
                          jb.bwt_forward_batched(j2, sentinel), ("L", "base", "rank")):
        _same(g, w, f"bwt_forward_batched {what}")
    sas = tb.suffix_arrays_batched(data2, sentinel, device="cpu")
    _same(sas, jb.suffix_arrays_batched(data2, sentinel), "suffix_arrays_batched")
    for row, sa in zip(data2, sas):
        _same(sa, golden.suffix_array(row, sentinel), "golden row")


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = np.frombuffer(b"banana", np.uint8)
    with pytest.raises(RuntimeError):
        tfa.suffix_array_fast(arr)
    with pytest.raises(RuntimeError):
        tb.suffix_arrays_batched(arr[None])
