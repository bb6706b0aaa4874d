"""Port's rank pipeline (archon_tpu_torch.core.fast2, the v2 half) vs
archon_tpu.core.fast2 and the golden suffix array.

Same numpy inputs through both packages; every comparison is exact (integer
outputs, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import fast2 as jf
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch.core import fast2 as tf

N = 32768


def _planted_binary(seed=13):
    """Binary text with a twice-planted 1000-byte segment: about 1600
    suffixes stay tied after context 192, under n/16, so the rank pipeline
    leaves the full rounds for the narrowed cascade."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 2, N, dtype=np.uint8)
    seg = rng.integers(0, 2, 1000, dtype=np.uint8)
    arr[1000:2000] = seg
    arr[N // 2 : N // 2 + 1000] = seg
    return arr


def _golden_ranks(arr, sentinel):
    sa = golden.suffix_array(arr, sentinel)
    rank = np.empty(len(arr), np.int64)
    rank[sa] = np.arange(len(arr))
    return rank


def _base3_windows(bits, w, sentinel):
    """Order-consistent base-3 windows of ``w`` bits: the a6 bit path's
    packing for the large sentinel (off-end digit 2), and digits 1/2 with
    off-end digit 0 for the small one."""
    if sentinel == "large":
        ext = np.concatenate([bits.astype(np.int32), np.full(w, 2, np.int32)])
    else:
        ext = np.concatenate([bits.astype(np.int32) + 1, np.zeros(w, np.int32)])
    win = np.zeros(len(bits), np.int32)
    for t in range(w):
        win = win * 3 + ext[t : len(bits) + t]
    return win


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("w", [1, 16])
def test_suffix_ranks_windows_matches_jax_and_golden(w, sentinel):
    rng = np.random.default_rng(w)
    if w == 1:  # byte windows: the ranks of the byte string itself
        arr = np.frombuffer(text_like(4000, 9), np.uint8)
        win = arr.astype(np.int32)
    else:  # bit windows, with a repeat that outlasts the bootstrap's 64 bits
        arr = rng.integers(0, 2, 6000, dtype=np.uint8)
        arr[4000:4300] = arr[100:400]
        win = _base3_windows(arr, w, sentinel)
    got = tf.suffix_ranks_windows(torch.tensor(win), w, sentinel).numpy()
    want = np.asarray(jf.suffix_ranks_windows(jnp.asarray(win), w, sentinel))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _golden_ranks(arr, sentinel))


def test_suffix_ranks_windows_tiny():
    for m in (0, 1):
        got = tf.suffix_ranks_windows(torch.zeros(m, dtype=torch.int32), 16, "large")
        assert got.dtype == torch.int32 and got.tolist() == [0] * m


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_v2_rank_functions_match_jax_and_golden(sentinel, monkeypatch):
    cascades = []
    cascade = tf._narrow_cascade

    def counted(*args):
        cascades.append(1)
        return cascade(*args)

    monkeypatch.setattr(tf, "_narrow_cascade", counted)
    cases = {"planted": _planted_binary(), "text": np.frombuffer(text_like(N, 2), np.uint8)}
    for name, arr in cases.items():
        t, j = torch.tensor(arr), jnp.asarray(arr)
        want_sa = golden.suffix_array(arr, sentinel)

        ranks = tf.suffix_ranks_v2(t, sentinel)
        assert np.array_equal(ranks.numpy(), np.asarray(jf.suffix_ranks_v2(j, sentinel))), name
        sa = tf.suffix_array_v2(t, sentinel).numpy()
        assert np.array_equal(sa, np.asarray(jf.suffix_array_v2(j, sentinel))), name
        assert np.array_equal(sa, want_sa), name
        assert np.array_equal(tf.suffix_array_fast2(arr.tobytes(), sentinel, device="cpu"),
                              jf.suffix_array_fast2(arr.tobytes(), sentinel)), name

        L, base, rank = tf.bwt_forward_v2(t, sentinel)
        jL, jbase, jrank = jf.bwt_forward_v2(j, sentinel)
        assert np.array_equal(L.numpy(), np.asarray(jL)), name
        assert base == int(jbase) and np.array_equal(rank.numpy(), np.asarray(jrank)), name
        want_L, want_base = golden.bwt_forward(arr, sentinel)
        assert np.array_equal(L.numpy(), want_L) and base == want_base, name
        if name == "planted":
            assert cascades, "the planted input must reach the narrowed cascade"


@pytest.mark.parametrize("data", [b"", b"a", b"ab", b"banana", b"\x00\x00\x01\x00"])
def test_v2_short_inputs_match_golden(data):
    arr = np.frombuffer(data, np.uint8)
    for sentinel in ("small", "large"):
        sa = tf.suffix_array_fast2(np.array(arr), sentinel, device="cpu")
        assert sa.dtype == np.int32
        assert sa.tolist() == golden.suffix_array(arr, sentinel).tolist()
        if len(arr):
            L, base, _ = tf.bwt_forward_v2(torch.tensor(arr), sentinel)
            want_L, want_base = golden.bwt_forward(arr, sentinel)
            assert L.tolist() == want_L.tolist() and base == want_base


def test_suffix_array_fast2_on_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tf.suffix_array_fast2(b"banana")
