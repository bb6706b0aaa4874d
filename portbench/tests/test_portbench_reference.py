"""The plain reference: the BWT against a frozen golden copy, the container
writers and parsers against blobs made here, and the control's depth cap."""

import heapq
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.gen.fibonacci import fibonacci_string
from portbench.gen.zipf_text import zipf_text
from portbench.reference import ata1, atm1
from portbench.reference.bwt import frame_bwt
from portbench.reference.huffman import build_encoder_var

from . import golden_sa

# a6 'var' code tables taken once from the JAX package's
# ``entropy/huffman.build_encoder_var``, which the repository's interop tests
# hold to the a6 binaries; a source the reference's builder was not copied into
HUFFMAN_TABLES = json.loads((Path(__file__).parent / "huffman_var_tables.json").read_text())["cases"]

CASES = {
    "text": zipf_text(3000, 5),
    "fibonacci": fibonacci_string(2048),
    "run": b"a" * 777,
    "period3": b"abc" * 300,
    "nested": (b"a" * 16 + b"b") * 60,
    "random": bytes(np.random.default_rng(3).integers(0, 256, 1500, dtype=np.uint8)),
    "zeros_ones": bytes(np.random.default_rng(4).integers(0, 2, 1500, dtype=np.uint8)),
    "one": b"x",
}


@pytest.mark.parametrize("generation", ["a4", "a7"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwt_equals_golden(case, generation):
    data = CASES[case]
    sentinel = golden_sa.SENT_SMALL if generation == "a4" else golden_sa.SENT_LARGE
    want_L, want_base = golden_sa.bwt_forward(np.frombuffer(data[::-1], np.uint8).copy(), sentinel)
    L, base = frame_bwt(data, generation, "cpu")
    assert base == want_base
    np.testing.assert_array_equal(L, want_L)


def test_depth_cap_breaks_deep_ties_only():
    deep = fibonacci_string(4096)
    assert frame_bwt(deep, "a4", "cpu", depth=16)[0].tobytes() != frame_bwt(deep, "a4", "cpu")[0].tobytes()
    shallow = bytes(range(200))
    assert frame_bwt(shallow, "a4", "cpu", depth=16)[1] == frame_bwt(shallow, "a4", "cpu")[1]


def _hand_ata1(data: bytes, block: int) -> bytes:
    out = b"ATA1" + struct.pack("<BBHI", 0, 0, 0, block)
    for i in range(0, len(data), block):
        blk = data[i : i + block]
        L, base = golden_sa.bwt_forward(np.frombuffer(blk[::-1], np.uint8).copy(), golden_sa.SENT_SMALL)
        out += struct.pack("<I", len(blk)) + L.tobytes() + struct.pack("<I", base)
    return out


def test_ata1_build_parse_diff():
    data = zipf_text(2500, 9)
    blob = ata1.build(data, "a4", 1000, "cpu")
    assert blob == _hand_ata1(data, 1000)
    header, frames = ata1.parse(blob)
    assert header == (b"ATA1", 0, 0, 0, 1000) and [n for n, _, _ in frames] == [1000, 1000, 500]
    assert ata1.diff(blob, blob) == {"header": 0, "frame_n": 0, "frame_L": 0, "frame_base": 0}
    bad = bytearray(blob)
    bad[12 + 4 + 3] ^= 1  # a byte of frame 0's L
    bad[12 + 1008 + 4 + 1000] ^= 1  # a byte of frame 1's base
    assert ata1.diff(bytes(bad), blob) == {"header": 0, "frame_n": 0, "frame_L": 1, "frame_base": 1}
    assert ata1.diff(blob[:-2], blob) == {"header": 3, "frame_n": 3, "frame_L": 3, "frame_base": 3}
    assert ata1.diff(blob[:-508], blob)["frame_L"] == 1  # a frame missing
    with pytest.raises(ValueError):
        ata1.parse(blob[:-1])


def _decode_bits(stream: bytes, nbits: int, codes) -> bytes:
    """A plain bit-by-bit decoder.  Bit b of the stream is bit b % 8 of byte
    b // 8, and each code is written from its last bit (bit 0) on, so read
    backward from the end the stream is a prefix code, last symbol first."""
    table = {(c.length, c.code): sym for sym, c in enumerate(codes) if c.length}
    out, acc, length = [], 0, 0
    for b in range(nbits - 1, -1, -1):
        acc = (acc << 1) | ((stream[b // 8] >> (b % 8)) & 1)
        length += 1
        if (length, acc) in table:
            out.append(table[(length, acc)])
            acc, length = 0, 0
    assert length == 0
    return bytes(out[::-1])


@pytest.mark.parametrize("size", [4000, 4003])
def test_atm1_build_decodes_back(size):
    data = zipf_text(size, 21)
    blob = atm1.build(data, "a4", 8, "var", "cpu")
    header, table, shards = atm1.parse(blob)
    magic, gen, coder, ns, n, base, pad = header
    assert (magic, gen, coder, ns, n, pad) == (b"ATM1", 0, 1, 8, size + (-size) % 8, (-size) % 8)
    arr, _ = atm1.padded(data, 8)
    L, want_base = golden_sa.bwt_forward(arr[::-1].copy(), golden_sa.SENT_SMALL)
    assert base == want_base
    hist = np.frombuffer(table, "<u4")
    np.testing.assert_array_equal(hist, np.bincount(L, minlength=256))
    codes = build_encoder_var(hist)
    S = n // 8
    for s, frame in enumerate(shards):
        (nbits,) = struct.unpack_from("<I", frame)
        assert _decode_bits(frame[4:], nbits, codes) == L[s * S : (s + 1) * S].tobytes()
    assert atm1.diff(blob, blob) == {"header": 0, "base": 0, "table": 0, "shard_bits": 0}
    bad = bytearray(blob)
    bad[-1] ^= 0x01
    assert atm1.diff(bytes(bad), blob) == {"header": 0, "base": 0, "table": 0, "shard_bits": 1}


def test_pack_bits_matches_loop():
    rng = np.random.default_rng(2)
    sym = rng.integers(0, 5, 999, dtype=np.uint8)
    codes = build_encoder_var(np.bincount(sym, minlength=256))
    values = torch.tensor([c.code for c in codes], dtype=torch.int64)
    lengths = torch.tensor([c.length for c in codes], dtype=torch.int64)
    nbits, stream = atm1.pack_bits(torch.from_numpy(sym), values, lengths)
    bits = []
    for s in sym:
        bits += [(codes[s].code >> j) & 1 for j in range(codes[s].length)]
    assert nbits == len(bits)
    bits += [0] * (-len(bits) % 8)
    want = bytes(sum(bits[i + j] << j for j in range(8)) for i in range(0, len(bits), 8))
    assert stream == want
    assert _decode_bits(stream, nbits, codes) == sym.tobytes()


def _optimal_cost(weights) -> int:
    """Total coded bits of an optimal prefix code: the sum of the weights
    of the nodes a textbook Huffman merge makes."""
    heap = list(weights)
    heapq.heapify(heap)
    cost = 0
    while len(heap) > 1:
        merged = heapq.heappop(heap) + heapq.heappop(heap)
        cost += merged
        heapq.heappush(heap, merged)
    return cost


def _check_code(freq, codes):
    present = [s for s in range(256) if freq[s]]
    assert all(codes[s].length == 0 for s in range(256) if not freq[s])
    if len(present) == 1:
        assert codes[present[0]].length == 0
        return
    assert sum(2.0 ** -codes[s].length for s in present) == 1.0  # Kraft's equality
    assert sum(freq[s] * codes[s].length for s in present) == _optimal_cost([freq[s] for s in present])
    words = sorted(format(codes[s].code, f"0{codes[s].length}b") for s in present)
    assert all(codes[s].code < 1 << codes[s].length for s in present)
    assert not any(b.startswith(a) for a, b in zip(words, words[1:]))  # prefix-free


@pytest.mark.parametrize("case", HUFFMAN_TABLES, ids=[c["name"] for c in HUFFMAN_TABLES])
def test_huffman_table_matches_the_jax_package(case):
    freq = [0] * 256
    for s, w in case["freq"].items():
        freq[int(s)] = w
    codes = build_encoder_var(freq)
    assert {str(s): [codes[s].code, codes[s].length] for s in range(256) if freq[s]} == case["codes"]
    _check_code(freq, codes)


@pytest.mark.parametrize("seed", range(6))
def test_huffman_lengths_are_optimal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 257))
    freq = np.zeros(256, np.int64)
    freq[rng.choice(256, n, replace=False)] = rng.integers(1, [2, 10, 1000, 10**6, 3, 50][seed], n)
    _check_code(freq.tolist(), build_encoder_var(freq.tolist()))
