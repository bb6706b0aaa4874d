"""The port's induced-sorting path (core/sais_tpu) against the JAX package's
and the golden model.

Same numpy inputs through both packages on the CPU, exact equality
(tolerance 0), both sentinels: the types on strings worked by hand,
``_joint_rank``, ``_next_pos``, ``_capped_ranks``, then ranks, suffix arrays
and the BWT on the cases of tests/test_sais_tpu.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import sais_tpu as js
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases, text_like
from archon_tpu_torch.core import sais_tpu as ts
from archon_tpu_torch.core.doubling import stats
from archon_tpu_torch.ops import sais as host_sais

SENTINELS = ["small", "large"]


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert np.array_equal(np.asarray(got), np.asarray(want)), what


@pytest.mark.parametrize("text,types", [
    # the textbook classification of mississippi$ (the terminator is S)
    (b"mississippi", "LSLLSLLSLLLS"),
    # a run takes the type of what follows it: b > $ makes b L, a < b makes both a's S
    (b"aab", "SSLS"),
    (b"baa", "LLLS"),
    (b"abab", "SLSLS"),
    (b"cccc", "LLLLS"),
    (b"abcd", "SSSLS"),
])
def test_types_on_hand_worked_strings(text, types):
    d = torch.tensor(list(text), dtype=torch.int32)
    got = "".join("S" if x else "L" for x in ts._types(d).tolist())
    assert got == types
    # and the definition itself, position by position
    s = list(text) + [-1]
    want = ["S"]
    for i in range(len(text) - 1, -1, -1):
        want.append("S" if s[i] < s[i + 1] or (s[i] == s[i + 1] and want[-1] == "S") else "L")
    assert got == "".join(reversed(want))


def test_joint_rank_and_next_pos_match_jax():
    rng = np.random.default_rng(11)
    n1 = 3000  # past the blocked scan's single-block width
    a1, a2 = (rng.integers(0, 6, n1).astype(np.int32) for _ in range(2))
    b1 = rng.integers(-1, 4, n1).astype(np.int32)
    b2 = np.where(rng.random(n1) < 0.3, 0x3FFFFFFF, rng.integers(0, 4, n1)).astype(np.int32)
    got = ts._joint_rank(_t(a1), _t(b1), _t(a2), _t(b2))
    want = js._joint_rank(*(jnp.asarray(x) for x in (a1, b1, a2, b2)))
    for g, w in zip(got, want):
        _same(g, w, "joint rank")
    for density in (0.0, 0.01, 0.5, 1.0):
        mask = rng.random(n1) < density
        _same(ts._next_pos(_t(mask), n1 - 1), js._next_pos(jnp.asarray(mask), n1 - 1),
              f"next_pos {density}")


@pytest.mark.parametrize("name", ["text", "small_alpha", "period"])
def test_capped_ranks_match_jax(name):
    rng = np.random.default_rng(3)
    data = {
        "text": np.frombuffer(text_like(1500), np.uint8),
        "small_alpha": rng.integers(0, 3, 1500, dtype=np.uint8),
        "period": np.frombuffer(b"abcab" * 300, np.uint8),
    }[name]
    n = len(data)
    d = _t(data).to(torch.int32)
    t = ts._types(d)
    lms = torch.cat([t.new_zeros(1), t[1:] & ~t[:-1]])
    u = torch.cat([d * 2 + t[:n].to(torch.int32) + 2, d.new_ones(1)])
    e_lms = ts._next_pos(lms, n)
    ref = _t(rng.integers(0, 40, n + 1).astype(np.int32))
    rounds = []
    for e, cap in ((e_lms, lms), (ts._next_pos(~t, n), ~t)):
        before = stats.rounds
        got = ts._capped_ranks(u, e, cap, ref)
        rounds.append(stats.rounds - before)
        want = js._capped_ranks(*(jnp.asarray(x.numpy()) for x in (u, e, cap, ref)))
        _same(got, want, "capped ranks")
    gap = int((e_lms - torch.arange(n + 1)).max())
    assert rounds[0] == gap.bit_length() + 1  # windows of 1, 2, 4, ... up to the largest gap


def _cases():
    rng = np.random.default_rng(0xA15)
    out = {
        "text": np.frombuffer(text_like(3000), np.uint8),
        "rand": rng.integers(0, 256, 2048, dtype=np.uint8),
        "small_alpha": rng.integers(0, 3, 1500, dtype=np.uint8),
        "tiny": np.frombuffer(b"mississippi", np.uint8),
        "two": np.frombuffer(b"ab", np.uint8),
        "one": np.frombuffer(b"z", np.uint8),
        "none": np.zeros(0, np.uint8),
        "incr": np.arange(200, dtype=np.uint8),
        "decr": np.arange(200, dtype=np.uint8)[::-1].copy(),
    }
    for name, blob in gauntlet_cases(1024).items():
        out[f"g_{name}"] = np.frombuffer(blob, np.uint8)
    return out


JAX_CASES = {"text", "rand", "small_alpha", "tiny", "two", "one", "incr", "g_zeros", "g_fibonacci",
             "g_nested", "g_period3"}


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_sais_matches_jax_and_golden(sentinel):
    for name, arr in _cases().items():
        want = golden.suffix_array(arr, sentinel)
        _same(ts.suffix_array_sais(_t(arr), sentinel), want, f"golden {sentinel} {name}")
        got = ts.suffix_ranks_sais(_t(arr), sentinel)
        assert got.dtype == torch.int32
        if name in JAX_CASES:  # the JAX side compiles a large program per length
            _same(got, js.suffix_ranks_sais(jnp.asarray(arr), sentinel), f"jax {sentinel} {name}")
        if sentinel == "small" and 0 < len(arr) <= 1100:  # the port's host SA-IS, its oracle
            _same(host_sais.sais(arr), want, f"host sais {name}")


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_sais_bwt_matches_jax_and_golden(sentinel):
    for name, arr in list(_cases().items())[:6]:
        L, base = ts.bwt_sais(_t(arr), sentinel)
        jL, jbase = js.bwt_sais(jnp.asarray(arr), sentinel)
        _same(L, jL, f"{sentinel} {name}")
        assert base == int(jbase), f"{sentinel} {name}"
        if len(arr) > 1:
            want_L, want_base = golden.bwt_forward(arr, sentinel)
            _same(L, want_L, f"golden {sentinel} {name}")
            assert base == int(want_base)


def test_sais_fuzz_small():
    rng = np.random.default_rng(3)
    for _ in range(20):
        for n in (5, 61, 119):
            arr = rng.integers(0, int(rng.integers(1, 7)), n, dtype=np.uint8)
            for sentinel in SENTINELS:
                _same(ts.suffix_array_sais(_t(arr), sentinel), golden.suffix_array(arr, sentinel),
                      (sentinel, arr.tolist()))


def test_sais_ranks_are_permutation():
    arr = np.frombuffer(text_like(4096, seed=5), np.uint8)
    r = ts.suffix_ranks_sais(_t(arr), "small").numpy()
    assert np.array_equal(np.sort(r), np.arange(len(arr)))
