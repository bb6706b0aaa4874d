"""Port's forward BWT (archon_tpu_torch.core.fast2) vs archon_tpu.core.fast2.

Same numpy inputs through both packages; every comparison is exact (integer
outputs, tolerance 0).  Stage by stage, every intermediate of the sorted-
order state (si, rs, ac, na, prev_s, ranks, active sets) must match bit for
bit: the port's sort is stable exactly where ``lax.sort`` is.  Then ``bwt_v3``
end to end on the cases of tests/test_fast2.py, against JAX and the golden
model, for both sentinels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import fast2 as jf
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases, text_like
from archon_tpu_torch.core import fast2 as tf


def _planted_repeat(n, rep_len, alpha, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, alpha, n, dtype=np.uint8)
    blk = rng.integers(0, alpha, rep_len, dtype=np.uint8)
    base[1000 : 1000 + rep_len] = blk
    base[n // 2 : n // 2 + rep_len] = blk
    return base.tobytes()


def _same(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert np.array_equal(np.asarray(got), np.asarray(want)), what


STAGE_INPUTS = {  # each leaves actives after the first full round
    "periodic": (lambda: b"abracadabra" * 300, "large"),
    "planted_binary": (lambda: _planted_repeat(32768, 500, 2, 12), "small"),
    "planted_bytes": (lambda: _planted_repeat(65536, 100, 256, 11), "large"),
}


@pytest.mark.parametrize("name", sorted(STAGE_INPUTS))
def test_stages_match_jax(name):
    make, sent = STAGE_INPUTS[name]
    arr = np.frombuffer(make(), np.uint8)
    n = len(arr)
    prev = np.roll(arr, 1)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731  (copies: the port scatters in place)

    _same(tf._trigram_keys(t(arr), sent), jf._trigram_keys(jnp.asarray(arr), sent), "p27")

    got = tf._bootstrap_sorted(t(arr), t(prev), sent)
    want = jf._bootstrap_sorted(jnp.asarray(arr), jnp.asarray(prev), sent)
    for g, w, what in zip(got, want, ("si", "rs", "ac", "na", "prev_s")):
        _same(g, w, f"bootstrap {what}")
    si, rs, ac, _, _ = want

    got = tf._round_full_sorted(t(si), t(rs), t(prev), 12, sent)
    want = jf._round_full_sorted(si, rs, jnp.asarray(prev), 12, sent)
    for g, w, what in zip(got, want, ("si", "rs", "ac", "na", "prev_s", "rank")):
        _same(g, w, f"full round {what}")
    si, rs, ac, na, _, G = want
    na = int(na)
    assert na > 0, "the stage input must leave actives after the first round"

    cap1, cap2, cap3 = tf._narrow_caps(n)
    assert (cap1, cap2, cap3) == jf._narrow_caps(n)
    for cap in (cap1, cap3):
        got = tf._compact_from_round(t(si), t(rs), t(ac), cap)
        want = jf._compact_from_round(si, rs, ac, cap)
        for g, w in zip(got, want):
            _same(g, w, f"compact cap={cap}")
    cap = 128  # n > cap * 32: the tiled extraction path
    got = tf._extract_actives_sorted(t(si), t(rs), t(ac), na, cap)
    want = jf._extract_actives_sorted(si, rs, ac, na, cap)
    for g, w in zip(got, want):
        _same(g, w, "extract actives")

    apos, ar0 = jf._extract_actives_sorted(si, rs, ac, na, cap3)
    for j_lo, j_hi in ((4, 16), (16, 64)):
        got = tf._micro_round(t(G), 12, t(apos), t(ar0), j_lo, j_hi, sent)
        want = jf._micro_round(G, 12, apos, ar0, j_lo, j_hi, sent)
        for g, w, what in zip(got, want, ("pos", "r", "na")):
            _same(g, w, f"micro {j_lo}-{j_hi} {what}")

    rank = jf._invert_permutation(si, rs)
    apos, ar0 = jf._compact_from_round(si, rs, ac, cap1)
    got = tf._round_active_c(t(rank), t(apos), t(ar0), 48, sent)
    want = jf._round_active_c(rank, apos, ar0, 48, sent)
    for g, w, what in zip(got, want, ("rank", "apos", "ar0", "na")):
        _same(g, w, f"narrowed round {what}")
    apos2, ar02 = want[1], want[2]
    got = tf._recompact(t(apos2), t(ar02), int(want[3]), cap3)
    want = jf._recompact(apos2, ar02, want[3], cap3)
    for g, w in zip(got, want):
        _same(g, w, "recompact")

    got = tf._narrow_cascade(t(rank), 48, na, t(apos), t(ar0), sent, (cap1, cap2, cap3))
    want = jf._narrow_cascade(rank, jnp.int32(48), jnp.int32(na), apos, ar0, sent,
                              (cap1, cap2, cap3))
    for g, w, what in zip(got, want, ("k", "rank", "na")):
        _same(g, w, f"cascade {what}")


def _check_bwt(cases, sentinel, jax_min_len):
    """Each case against the golden model; those of ``jax_min_len`` bytes or
    more also against JAX bwt_v3 (each new length costs JAX a compile)."""
    for data in cases:
        arr = np.frombuffer(bytes(data), np.uint8)
        L, base = tf.bwt_v3(torch.tensor(arr), sentinel)
        want_L, want_base = golden.bwt_forward(arr, sentinel)
        assert L.numpy().tolist() == want_L.tolist(), f"{sentinel} n={len(data)}"
        assert base == int(want_base), f"{sentinel} n={len(data)}"
        if len(data) >= jax_min_len:
            jL, jbase = jf.bwt_v3(jnp.asarray(arr), sentinel)
            assert np.array_equal(L.numpy(), np.asarray(jL))
            assert base == int(jbase)


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_bwt_v3_direct_and_gauntlet_match_jax(sentinel):
    """tests/test_fast2.py's v3 cases: direct exit, narrowed path, gauntlet
    (the short cases against the golden model only)."""
    rng = np.random.default_rng(7)
    cases = [
        b"", b"a", b"ab", b"banana", b"mississippi" * 40,
        bytes(128),
        text_like(3000, 2),
        bytes(rng.integers(0, 4, 5000, dtype=np.uint8)),
    ]
    cases += list(gauntlet_cases(701).values())
    _check_bwt(cases, sentinel, jax_min_len=701)


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_bwt_v3_micro_tail_and_cascade_match_jax(sentinel):
    """Micro tail with G = p27, micro tail with G = rank, and micro ->
    cascade fallback (the shapes of tests/test_fast2.py)."""
    cases = [
        _planted_repeat(65536, 100, 256, 11),
        _planted_repeat(32768, 500, 2, 12),
        _planted_repeat(32768, 1000, 2, 13),
    ]
    _check_bwt(cases, sentinel, jax_min_len=0)


def test_bwt_v3_three_cap_cascade_matches_golden(monkeypatch):
    """n > 2^20: three distinct narrowing capacities (n/16, n/256, 4096).
    A twice-planted 3000-byte segment and a 4000-byte run leave ~10^4
    actives after the bootstrap (past the micro tail's reach, under n/16):
    the cascade runs rounds at cap1, re-compacts to cap2 and to cap3 and
    resolves there.  Held against the golden model."""
    n = (1 << 20) + (1 << 14)
    cap1, cap2, cap3 = tf._narrow_caps(n)
    assert cap1 > cap2 > cap3
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, n, dtype=np.uint8)
    seg = rng.integers(0, 256, 3000, dtype=np.uint8)
    arr[10_000:13_000] = seg
    arr[600_000:603_000] = seg
    arr[200_000:204_000] = 97
    widths = []
    round_c, recompact = tf._round_active_c, tf._recompact

    def counted_round(rank, apos, *rest):
        widths.append(apos.shape[0])
        return round_c(rank, apos, *rest)

    def counted_recompact(apos, ar0, na, cap_to):
        widths.append(cap_to)
        return recompact(apos, ar0, na, cap_to)

    monkeypatch.setattr(tf, "_round_active_c", counted_round)
    monkeypatch.setattr(tf, "_recompact", counted_recompact)
    L, base = tf.bwt_v3(torch.tensor(arr), "small")
    assert cap1 in widths and cap2 in widths and widths[-1] == cap3
    want_L, want_base = golden.bwt_forward(arr, "small")
    assert np.array_equal(L.numpy(), want_L) and base == int(want_base)


def test_bwt_v3_payload_matches_jax():
    rng = np.random.default_rng(21)
    arr = rng.integers(0, 3, 4000, dtype=np.uint8)
    pay = rng.integers(0, 256, 4000, dtype=np.uint8)
    L, base = tf.bwt_v3_payload(torch.tensor(arr), torch.tensor(pay), "large")
    jL, jbase = jf.bwt_v3_payload(jnp.asarray(arr), jnp.asarray(pay), "large")
    assert np.array_equal(L.numpy(), np.asarray(jL)) and base == int(jbase)


@pytest.mark.parametrize("n", [1, 2048, 2049, 5000, 1 << 16])
def test_blocked_cummax_matches_jax(n):
    from archon_tpu.ops.scan import blocked_cummax as jcummax
    from archon_tpu_torch.ops.scan import blocked_cummax

    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int64).astype(np.int32)
    got = blocked_cummax(torch.tensor(x)).numpy()
    assert np.array_equal(got, np.maximum.accumulate(x))
    assert np.array_equal(got, np.asarray(jcummax(jnp.asarray(x))))
