"""Port's device inverse BWT (archon_tpu_torch.core.unbwt) vs
archon_tpu.core.unbwt and the golden walk, on the CPU.

Same numpy inputs through both packages; every comparison is exact (integer
outputs, tolerance 0).  Both walk branches run: plain doubling for
n <= 2 * _WALK_K, squaring plus the lockstep walk above it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu import formats as jformats
from archon_tpu.core import unbwt as ju
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import formats
from archon_tpu_torch.core import unbwt as tu

SMALL_N = 5000  # plain doubling
LARGE_N = 20011  # squaring to P^K, then the lockstep walk (as tests/test_jax_core.py)


def _bwt(n, sentinel, seed):
    arr = np.frombuffer(text_like(n, seed), np.uint8)
    L, base = golden.bwt_forward(arr, sentinel)
    return arr, L, int(base)


def test_walk_branches_are_the_ones_named():
    assert SMALL_N <= 2 * tu._WALK_K < LARGE_N
    assert tu._WALK_K == ju._WALK_K


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_lf_successor_matches_jax(sentinel):
    _, L, base = _bwt(SMALL_N, sentinel, 3)
    got = tu.lf_successor(torch.tensor(L), base, sentinel)
    assert got.dtype == torch.int32
    want = ju.lf_successor(jnp.asarray(L), jnp.int32(base), sentinel)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_lf_successor_with_starts_matches_jax():
    _, L, base = _bwt(SMALL_N, "large", 4)
    counts = np.bincount(L, minlength=256)
    order = np.random.default_rng(4).permutation(256)  # buckets in another order
    starts = np.zeros(256, np.int64)
    starts[order] = np.concatenate([[0], np.cumsum(counts[order])[:-1]])
    got = tu.lf_successor(torch.tensor(L), base, "large", torch.tensor(starts))
    want = ju.lf_successor(jnp.asarray(L), jnp.int32(base), "large",
                           jnp.asarray(starts, jnp.int32))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("n", [SMALL_N, LARGE_N])
def test_bwt_inverse_matches_jax_and_golden(n, sentinel):
    arr, L, base = _bwt(n, sentinel, 13)
    got = tu.bwt_inverse(torch.tensor(L), base, sentinel)
    assert got.dtype == torch.uint8
    want = ju.bwt_inverse(jnp.asarray(L), jnp.int32(base), sentinel)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), golden.bwt_inverse(L, base, sentinel))
    assert np.array_equal(got.numpy(), arr[::-1])  # the reverse of the pre-BWT string


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_bwt_inverse_tiny(sentinel):
    one = tu.bwt_inverse(torch.tensor([7], dtype=torch.uint8), 0, sentinel)
    assert one.tolist() == [7]
    empty = tu.bwt_inverse(torch.zeros(0, dtype=torch.uint8), 0, sentinel)
    assert empty.dtype == torch.uint8 and empty.numel() == 0
    for data in (b"ab", b"banana", b"mississippi"):
        arr = np.frombuffer(data, np.uint8)
        L, base = golden.bwt_forward(arr, sentinel)
        got = tu.bwt_inverse(torch.tensor(L), int(base), sentinel).numpy()
        assert got.tolist() == golden.bwt_inverse(L, base, sentinel).tolist()


@pytest.mark.parametrize("n", [SMALL_N, LARGE_N])
def test_bwt_inverse_with_starts_matches_jax(n):
    """Buckets in a codeword-like order: the a6 var inverse's shape."""
    from archon_tpu.core import a6 as j6

    data = text_like(n, 8)
    blob = j6.a6_encode(data, "var")
    L = np.frombuffer(blob[4:], np.uint8)
    base = int(np.frombuffer(blob[:4], np.uint32)[0])
    counts = np.bincount(L, minlength=256)
    codes = j6.build_encoder_var(counts)
    keys = np.array([(c.code << (32 - c.length)) if c.length else -1 for c in codes], np.int64)
    starts = np.zeros(256, np.int64)
    acc = 0
    for c in np.argsort(keys, kind="stable"):
        starts[c], acc = acc, acc + int(counts[c])
    got = tu.bwt_inverse_with_starts(torch.tensor(L), base, torch.tensor(starts)).numpy()
    want = ju.bwt_inverse_with_starts(jnp.asarray(L), jnp.int32(base),
                                      jnp.asarray(starts, jnp.int32))
    assert np.array_equal(got, np.asarray(want))
    assert got.tobytes() == data
    assert tu.bwt_inverse_with_starts(torch.zeros(0, dtype=torch.uint8), 0,
                                      torch.tensor(starts)).numel() == 0


def test_compose_perm_is_the_gather():
    rng = np.random.default_rng(1)
    g, h = (torch.tensor(rng.permutation(1000).astype(np.int32)) for _ in range(2))
    want = ju._compose_perm(jnp.asarray(g.numpy()), jnp.asarray(h.numpy()))
    assert np.array_equal(tu._compose_perm(g, h).numpy(), np.asarray(want))


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_formats_decode_on_device_roundtrips(generation):
    for data in (b"x", b"banana", text_like(SMALL_N, 5), text_like(LARGE_N, 6)):
        blob = formats.encode(data, generation, device="cpu")
        assert formats.decode(blob, generation, device="cpu") == data
        assert formats.decode(blob, generation) == data
        assert jformats.decode(blob, generation, device=True) == data
    assert formats.decode(np.uint32(0).tobytes(), generation, device="cpu") == b""
    with pytest.raises(ValueError):
        formats.decode(b"ab" + np.uint32(5).tobytes(), generation, device="cpu")


def test_formats_decode_on_missing_cuda_raises(monkeypatch):
    blob = formats.encode(b"banana", "a4", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        formats.decode(blob, "a4", device="cuda")
