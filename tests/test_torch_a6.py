"""Port's a6 compressor (archon_tpu_torch.core.a6, ops.bitpack) vs
archon_tpu.core.a6 and the golden a6 model, on the CPU.

Same numpy inputs through both packages; every comparison is exact (bytes
and integers, tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import a6 as j6
from archon_tpu.entropy.huffman import SymbolCode
from archon_tpu.golden import a6 as g6
from archon_tpu.ops import bitpack as jbitpack
from archon_tpu.utils.corpus import markup_like, text_like
from archon_tpu_torch import cli
from archon_tpu_torch.core import a6 as t6
from archon_tpu_torch.ops import bitpack

CONFIGS = ["byte", "fix", "var"]
ORDERS = ["freq", "greedy", "topo", "bubble"]


def _cases():
    """The cases of tests/test_jax_a6.py."""
    rng = np.random.default_rng(0x66)
    out = [b"banana", b"abracadabra alakazam", text_like(997)]
    for _ in range(3):
        out.append(bytes(rng.integers(0, 50, 256, dtype=np.uint8)))
    return out


def _hostile_cases():
    """The symbol-reduction edge cases of tests/test_jax_a6.py: all-ones
    codewords, runs entering the TERMIN tail, tiny alphabets, markup."""
    rng = np.random.default_rng(0xA6)
    return [
        b"\xff" * 300,
        b"\xff" * 120 + b"\x00" * 120,
        b"ab" * 200 + b"a",
        b"aab" * 150,
        bytes(rng.integers(0, 3, 700, dtype=np.uint8)),
        bytes(rng.integers(250, 256, 500, dtype=np.uint8)),
        markup_like(3000),
        text_like(2500) + b"\xff" * 64,
    ]


@pytest.mark.parametrize("config", CONFIGS)
def test_pack_codes_and_bits_match_jax(config):
    data = np.frombuffer(text_like(3000, 4), np.uint8)
    codes = t6.build_codes(data, config)
    max_len = max(c.length for c, f in zip(codes, np.bincount(data, minlength=256)) if f)
    vals, lens = t6._code_arrays(codes, "cpu")
    jvals, jlens = j6._code_arrays(codes)
    for size in (max_len, 32):
        words, ends, total = bitpack.pack_codes_sized(torch.tensor(data), vals, lens, size)
        jw, je, jt = jbitpack.pack_codes_sized(jnp.asarray(data), jvals, jlens, size)
        assert np.array_equal(words.numpy().astype(np.uint32), np.asarray(jw))
        assert words.max() < 1 << 32 and words.min() >= 0
        assert np.array_equal(ends.numpy(), np.asarray(je)) and int(total) == int(jt)
        bits = bitpack.words_to_bits(words)
        assert bits.dtype == torch.uint8
        assert np.array_equal(bits.numpy(), np.asarray(jbitpack.words_to_bits(jw)))
    got = bitpack.pack_codes(torch.tensor(data), vals, lens)
    assert np.array_equal(got[0].numpy().astype(np.uint32),
                          np.asarray(jbitpack.pack_codes(jnp.asarray(data), jvals, jlens)[0]))


def test_code_tables_match_jax():
    for data in _cases() + _hostile_cases():
        arr = np.frombuffer(data, np.uint8)
        freq = np.bincount(arr, minlength=256)
        for config in CONFIGS:
            # the port's tables are instances of its own copy of SymbolCode
            codes, jcodes = t6.build_codes(arr, config), j6.build_codes(arr, config)
            assert [(c.code, c.length) for c in codes] == [(c.code, c.length) for c in jcodes]
            assert np.array_equal(t6._symbol_rank_map(codes), j6._symbol_rank_map(jcodes))
            assert t6._uniform_width(codes, freq) == j6._uniform_width(jcodes, freq)
    with pytest.raises(ValueError):
        t6.build_codes(np.zeros(3, np.uint8), "huff")


@pytest.mark.parametrize("config", CONFIGS)
def test_a6_encode_matches_jax_and_golden(config):
    for data in _cases():
        got = t6.a6_encode(data, config, device="cpu")
        assert got == j6.a6_encode(data, config), f"{config} n={len(data)}"
        try:
            want = g6.a6_encode(data, config)
        except ValueError:  # the golden model refuses some var tables
            want = None
        if want is not None:
            assert got == want, f"{config} n={len(data)}"
        assert t6.a6_decode(got, config, device="cpu") == data


@pytest.mark.parametrize("config", ["fix", "var"])
def test_symbol_path_equals_bit_path(config):
    for data in _hostile_cases():
        arr = np.frombuffer(data, np.uint8)
        sym_out, sym_base = t6.a6_forward(arr, config, impl="symbol", device="cpu")
        bit_out, bit_base = t6.a6_forward(arr, config, impl="bits", device="cpu")
        assert sym_base == bit_base, f"{config} n={len(data)}"
        assert sym_out.tobytes() == bit_out.tobytes(), f"{config} n={len(data)}"


def test_bit_path_matches_jax():
    arr = np.frombuffer(markup_like(3000), np.uint8)
    got = t6.a6_forward(arr, "var", impl="bits", device="cpu")
    want = j6.a6_forward(arr, "var", impl="bits")
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


def test_single_symbol_var_takes_the_bit_path():
    """One symbol under var has a zero-length code: the bit path with
    max_len clamped to 1."""
    data = b"\x07" * 700
    codes = t6.build_codes(np.frombuffer(data, np.uint8), "var")
    assert codes[7].length == 0
    blob = t6.a6_encode(data, "var", device="cpu")
    assert blob == j6.a6_encode(data, "var")
    assert t6.a6_decode(blob, "var", device="cpu") == data


def test_code_longer_than_32_bits_raises():
    codes = [SymbolCode(0, 8)] * 255 + [SymbolCode(1, 33)]
    for fn in (t6._check_code_lengths, t6._symbol_rank_map):
        with pytest.raises(ValueError, match="32-bit"):
            fn(codes)
    with pytest.raises(ValueError, match="32-bit"):
        t6._code_arrays(codes, "cpu")


def test_bit_path_width_limit_raises():
    """Past the sort's 2^30 width the bit path raises instead of sorting
    a cut stream (checked before any tensor of that size is made)."""
    n = (1 << 30) // 16
    with pytest.raises(ValueError, match="bit path"):
        t6._a6_transform(torch.zeros(n, dtype=torch.uint8), torch.zeros(256, dtype=torch.int64),
                         torch.zeros(256, dtype=torch.int32), max_len=16)


@pytest.mark.parametrize("order", ORDERS)
def test_order_extension_matches_jax(order):
    data = text_like(997)
    for config in ("byte", "var"):
        got = t6.a6_encode(data, config, order=order, device="cpu")
        assert got[:4] == b"AO1\xff"
        assert got == j6.a6_encode(data, config, order=order)
        assert t6.a6_decode(got, config, order=order, device="cpu") == data
        assert t6.a6_decode(got, config, device="cpu") == data  # the blob names its order


def test_a6_decode_stated_order_mismatch_raises():
    plain = t6.a6_encode(b"banana bandana", "byte", device="cpu")
    assert t6.a6_decode(plain, "byte", order="none", device="cpu") == b"banana bandana"
    with pytest.raises(ValueError, match="no order table"):
        t6.a6_decode(plain, "byte", order="freq", device="cpu")
    with pytest.raises(ValueError, match="no order table"):
        j6.a6_decode(plain, "byte", order="freq")


def test_a6_empty_input():
    for config in CONFIGS:
        blob = t6.a6_encode(b"", config, device="cpu")
        assert blob == j6.a6_encode(b"", config) == bytes(4)
        assert t6.a6_decode(blob, config, device="cpu") == b""


def test_var_decode_without_the_native_walk(monkeypatch):
    """Without the native library the var decode walks on ``device`` (the
    port's bwt_inverse_with_starts), never through the JAX package."""
    from archon_tpu import native

    data = text_like(3000, 11)
    blob = t6.a6_encode(data, "var", device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "unbwt_starts", None)
    assert t6.a6_decode(blob, "var", device="cpu") == data


def test_a6_on_missing_cuda_raises(monkeypatch):
    blob = t6.a6_encode(b"banana", "byte", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        t6.a6_encode(b"banana")
    with pytest.raises(RuntimeError):
        t6.a6_decode(blob)


@pytest.mark.parametrize("config", CONFIGS)
def test_cli_a6_roundtrip(tmp_path, config):
    data = text_like(5000, 12)
    src, enc, back = tmp_path / "in.bin", tmp_path / "out.a6", tmp_path / "back.bin"
    src.write_bytes(data)
    args = ["-c", config, "-r", "8", "--device", "cpu"]
    assert cli.main(["a6", str(src), str(enc), *args]) == 0
    assert enc.read_bytes() == j6.a6_encode(data, config)
    assert cli.main(["a6", str(enc), str(back), "-u", *args]) == 0
    assert back.read_bytes() == data
    assert cli.main(["a6", str(src), str(enc), "-o", "freq", *args]) == 0
    assert enc.read_bytes() == j6.a6_encode(data, config, order="freq")
    assert cli.main(["a6", str(enc), str(back), "-u", "-o", "freq", *args]) == 0
    assert back.read_bytes() == data


def test_cli_config_fills_the_a6_fields():
    args = cli._parser().parse_args(["a6", "in", "out", "-c", "var", "-o", "topo", "-r", "12"])
    cfg = cli._config_from_args(args)
    assert (cfg.generation, cfg.coder, cfg.order, cfg.radix) == ("a6", "var", "topo", 12)
