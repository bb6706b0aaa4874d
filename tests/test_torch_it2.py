"""The port's IT-2 reduced-volume BWT (core/it2) and ``impl="it2"`` against
the JAX package's.

Same numpy inputs through both packages on the CPU, exact equality
(tolerance 0), both sentinels: the predicate, caps and phrase keys, the
outputs of ``_it2_stage1`` and ``_it2_merge`` element for element, then
``(L, base, ok)`` on the corpora, fuzz families and Gauntlet cases of
tests/test_it2.py (exact or flagged, the flag itself equal to JAX's), the
residual cascade, and the container: equal to the JAX package's and to the
port's stream, ATA1 and ATA2, with a block that forces the ``bwt_v3``
fallback.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import fast2 as jf2
from archon_tpu.core import it2 as jit
from archon_tpu.io import blocks as jblocks
from archon_tpu.utils.corpus import gauntlet_cases, markup_like, text_like
from archon_tpu_torch.core import fast2 as tf2
from archon_tpu_torch.core import it2 as tit
from archon_tpu_torch.io import blocks
from archon_tpu_torch.ops.itn import it2_lucky

SENTINELS = ["small", "large"]
D = 11
N = 4096  # one block size for stages and containers: the JAX side compiles per shape


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert np.array_equal(np.asarray(got), np.asarray(want)), what


def _deep_repeat():
    """Random bytes with one long ascending run planted twice after
    different bytes: its inner suffixes tie through the merge's keys (deeper
    than D), no phrase name collides, so the residual cascade runs and the
    result stays exact."""
    rng = np.random.default_rng(1)
    a = rng.integers(100, 200, N, dtype=np.uint8)
    run = np.arange(40, 80, dtype=np.uint8)
    a[1000:1040], a[999], a[1040] = run, 250, 30
    a[3000:3040], a[2999], a[3040] = run, 251, 31
    return a


STAGE_INPUTS = {
    "text": lambda: np.frombuffer(text_like(N, seed=2), np.uint8),
    "markup": lambda: np.frombuffer(markup_like(N), np.uint8),
    "deep_repeat": _deep_repeat,
    "period_long": lambda: np.frombuffer(gauntlet_cases(N)["period_long"], np.uint8),
    "zeros": lambda: np.frombuffer(gauntlet_cases(N)["zeros"], np.uint8),
}


@pytest.mark.parametrize("name", sorted(STAGE_INPUTS))
def test_stages_match_jax(name):
    arr = STAGE_INPUTS[name]()
    n = len(arr)
    M = tit._reduced_capacity(n)
    assert M == min(n, max(4096, 1 << (int(n * 0.45) - 1).bit_length()))
    d32 = _t(arr).to(torch.int32)
    j32 = jnp.asarray(arr).astype(jnp.int32)

    lucky = tit._lucky_mask(d32)
    _same(lucky, jit._lucky_mask(j32), "lucky")
    # the host predicate pads the last position differently: the interior agrees
    _same(lucky[:-1], it2_lucky(arr)[:-1], "lucky against the host predicate")
    e = tit._next_pos(lucky, n)
    _same(e, jit._next_lucky(jnp.asarray(lucky.numpy()), n), "next lucky")
    dist = e - torch.arange(n, dtype=torch.int32)
    for g, w in zip(tit._phrase_keys(d32, dist, D), jit._phrase_keys(j32, jnp.asarray(dist.numpy()), D)):
        _same(g, w, "phrase keys")

    keys, dist, s1, bad_name, overflow = tit._it2_stage1(_t(arr), D, M)
    *jkeys, jdist, js1, jqpos, jbad, jover = jit._it2_stage1(jnp.asarray(arr), D, M)
    assert len(keys) == len(jkeys) == (D + 1) // 3
    for g, w in zip(keys, jkeys):
        _same(g, w, "stage1 keys")
    _same(dist, jdist, "stage1 dist")
    _same(s1, js1, "stage1 s1")
    assert bool(bad_name) == bool(jbad) and bool(overflow) == bool(jover)

    jr = jf2.suffix_ranks_windows(js1, 1, "small")
    r_star = tf2.suffix_ranks_windows(s1, 1, "small")
    _same(r_star, jr, "reduced ranks")

    prev = np.roll(arr, 1)
    got = tit._it2_merge(_t(arr), _t(prev), keys, dist, r_star, D)
    want = jit._it2_merge(jnp.asarray(arr), jnp.asarray(prev), tuple(jkeys), jdist, jqpos, jr, D)
    for g, w, what in zip(got, want, ("L", "base", "na", "ranks_sorted", "mpos_s", "active_s")):
        _same(g, w, f"merge {what}")
    na = int(want[2])
    if na:
        L, base = tit._it2_residual(_t(prev), *(_t(x) for x in (want[0], want[3], want[4], want[5])),
                                    na, D)
        jL, jbase = jit._it2_residual(jnp.asarray(prev), want[0], want[3], want[4], want[5],
                                      want[2], D)
        if na <= tf2._narrow_caps(n)[0]:  # beyond it both are flagged and L is not read
            _same(L, jL, "residual L")
            assert base == int(jbase)
    assert (na > 0) == (name in ("deep_repeat", "zeros"))


def _check(arr, sent):
    """(L, base, ok) of the port against the JAX package's; where ok, against
    the port's ``bwt_v3`` too.  Returns "exact" or "flagged"."""
    L, base, ok = tit.bwt_it2(_t(arr), sent)
    jL, jbase, jok = jit.bwt_it2(jnp.asarray(arr), sent)
    assert isinstance(ok, bool) and isinstance(base, int)
    assert ok == bool(jok)
    if not ok:
        return "flagged"
    _same(L, jL, "L")
    assert base == int(jbase)
    Lw, bw = tf2.bwt_v3(_t(arr), sent)
    assert torch.equal(L, Lw) and base == bw
    return "exact"


@pytest.mark.parametrize("sent", SENTINELS)
def test_it2_matches_jax_on_corpora(sent):
    assert _check(np.frombuffer(text_like(16384), np.uint8), sent) == "exact"
    assert _check(np.frombuffer(markup_like(16384), np.uint8), sent) == "exact"


@pytest.mark.parametrize("sent", SENTINELS)
def test_it2_fuzz_random_families(sent):
    rng = np.random.default_rng(7)
    for _ in range(4):  # tests/test_it2.py draws 6; each n is a shape the JAX side compiles
        hi = int(rng.integers(3, 257))
        n = int(rng.integers(2, 6000))
        _check(rng.integers(0, hi, n).astype(np.uint8), sent)  # exact or flagged, as JAX


@pytest.mark.parametrize("sent", SENTINELS)
def test_it2_gauntlet_exact_or_flagged(sent):
    seen = {_check(np.frombuffer(g, np.uint8), sent) for g in gauntlet_cases(32768).values()}
    assert seen == {"exact", "flagged"}


def test_it2_residual_cascade_stays_exact():
    assert _check(_deep_repeat(), "small") == "exact"


def test_it2_edges():
    for data in (b"", b"a", b"ba", b"ab", b"aaaa", b"banana"):
        arr = np.frombuffer(data, np.uint8)
        for sent in SENTINELS:
            if len(arr) > 1:
                _check(arr, sent)
            else:
                L, base, ok = tit.bwt_it2(_t(arr), sent)
                assert L.tolist() == list(data) and base == 0 and ok is True


def test_it2_async_defers_the_read_back():
    """``bwt_it2_async`` returns before any result is read; ``finish`` gives
    what ``bwt_it2`` gives, for a window of blocks finished out of order."""
    blocks_ = [np.frombuffer(text_like(N, seed=s), np.uint8) for s in range(3)]
    finishes = [tit.bwt_it2_async(_t(b), "large") for b in blocks_]
    for b, fin in reversed(list(zip(blocks_, finishes))):
        L, base, ok = fin()
        Lw, bw, okw = tit.bwt_it2(_t(b), "large")
        assert torch.equal(L, Lw) and base == bw and ok and okw


@pytest.mark.parametrize("generation", ["a4", "a7"])
@pytest.mark.parametrize("pack", [False, True], ids=["ATA1", "ATA2"])
def test_container_it2_equals_jax_and_stream(generation, pack):
    data = text_like(5 * N + 100, seed=13)
    got = blocks.encode_file(data, generation, N, impl="it2", pack=pack, device="cpu")
    assert got == jblocks.encode_file(data, generation, block_size=N, impl="it2", pack=pack)
    assert got == blocks.encode_file(data, generation, N, impl="stream", pack=pack, device="cpu")
    assert got[:4] == (b"ATA2" if pack else b"ATA1")
    assert blocks.decode_file(got) == data


@pytest.mark.parametrize("verify", [True, False])
def test_container_it2_forced_fallback(verify, tmp_path):
    """A block IT-2 flags (equal phrases deeper than its window: an
    ascending run of 20 bytes, repeated) is recomputed by ``bwt_v3`` and
    counted; the container still equals the stream's and the JAX one."""
    deep = (bytes(range(40, 60)) * (N // 20 + 1))[:N]
    assert tit.bwt_it2(_t(np.frombuffer(deep, np.uint8)), "small")[2] is False
    data = deep + text_like(N, seed=14)
    blocks._streamed_forward.it2_fallbacks = 0
    got = blocks.encode_file(data, "a4", N, impl="it2", verify=verify, device="cpu")
    assert blocks._streamed_forward.it2_fallbacks == 1
    assert got == blocks.encode_file(data, "a4", N, impl="stream", device="cpu")
    assert got == jblocks.encode_file(data, "a4", block_size=N, impl="it2")
    assert blocks.decode_file(got) == data
    out = tmp_path / "o.at"
    assert blocks.encode_to_path(data, out, "a4", N, impl="it2", verify=verify,
                                 device="cpu") == 2
    assert out.read_bytes() == got and blocks._streamed_forward.it2_fallbacks == 2


def test_it2_debug_ticks(monkeypatch, capsys):
    monkeypatch.setenv("ARCHON_IT2_DEBUG", "1")
    tit.bwt_it2(_t(_deep_repeat()), "small")
    out = capsys.readouterr().out
    for label in ("stage1", "windows", "merge", "residual"):
        assert f"[it2-debug] {label}: forced in" in out


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        blocks.encode_file(b"abc" * 100, "a4", 64, impl="it2")
