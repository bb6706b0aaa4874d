"""The ATA2 pack of L rows where they lie (``ops.pack``, ``entropy.pack.RowPack``)
against the host pack (``native.mtf_rle0``, ``native.bitpack16``,
``entropy.pack.pack_block``), byte for byte.

Everything runs on the CPU through the kernels' plain twins, at chunk sizes
that put zero runs and symbol changes across chunk edges; the kernels are
held to the same twins on the card in ``tests/test_torch_cuda.py``.
"""

import struct

import numpy as np
import pytest
import torch

from archon_tpu_torch import native
from archon_tpu_torch.entropy import pack
from archon_tpu_torch.io import blocks
from archon_tpu_torch.ops import pack as ops_pack
from portbench.gen.zipf_text import zipf_text
from portbench.reference import ata2

CHUNKS = [7, 64, 997]


def _runs_block(lengths) -> np.ndarray:
    """Zero runs of each length: of the first symbol, after a change of
    symbol, and at the end of the block."""
    parts = []
    for k in lengths:
        parts += [9] * k + [200, 9] + [200] * k + [3] + [3] * k
    return np.array(parts, np.uint8)


def _all_symbols_block() -> np.ndarray:
    """Every byte value inside the first 997 bytes, in a scrambled order,
    then runs."""
    rng = np.random.default_rng(3)
    head = rng.permutation(256).astype(np.uint8)
    return np.concatenate([head, np.repeat(head[::-1], 3), np.zeros(300, np.uint8), head[:7]])


def _hold_to_native(L: np.ndarray, chunk: int) -> None:
    """The twin's stream, histogram, m and words equal the native ones."""
    state = ops_pack.mtf_rle_ref(torch.from_numpy(L[None].copy()), chunk)
    want = native.mtf_rle0(L).astype(np.int64)
    assert np.array_equal(ops_pack.symbols(state)[0].numpy(), want)
    hist = np.bincount(want, minlength=ops_pack.NSYM)
    assert np.array_equal(state.head[0, : ops_pack.NSYM].numpy(), hist)
    assert int(state.head[0, ops_pack.NSYM]) == len(want)
    assert np.array_equal(state.chist[0].sum(0).numpy(), hist)
    present = np.nonzero(hist)[0]
    if len(present) < 2:
        return
    vals, lens, _maxlen = pack._codes_for(present, hist[present])
    words, nbits = native.bitpack16(want, vals, lens)
    nwords = (nbits + 31) // 32
    got = ops_pack.pack_words_ref(
        state, torch.from_numpy(vals.view(np.int32).copy())[None],
        torch.from_numpy(lens.astype(np.int32))[None], torch.tensor([0]), nwords)
    assert np.array_equal(got.numpy().view(np.uint32), words[:nwords])


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("lengths", [
    list(range(1, 71)),
    [(1 << k) + d for k in range(2, 13) for d in (-1, 1)],
], ids=["1-70", "2^k+-1"])
def test_twin_matches_native_on_zero_runs(chunk, lengths):
    _hold_to_native(_runs_block(lengths), chunk)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", ["all 256 symbols", "one symbol", "n = 1", "n = 1 nonzero",
                                  "zipf text"])
def test_twin_matches_native_on_edge_blocks(chunk, case):
    L = {
        "all 256 symbols": _all_symbols_block(),
        "one symbol": np.full(3000, 77, np.uint8),
        "n = 1": np.zeros(1, np.uint8),
        "n = 1 nonzero": np.array([200], np.uint8),
        "zipf text": np.frombuffer(zipf_text(6000, 2**31 + 3), np.uint8),
    }[case]
    _hold_to_native(L, chunk)


def test_twin_matches_native_on_random_blocks():
    rng = np.random.default_rng(2**31 + 9)
    for _ in range(12):
        n = int(rng.integers(1, 4000))
        L = rng.integers(0, int(rng.integers(1, 257)), n).astype(np.uint8)
        L = np.repeat(L, rng.integers(1, 40, n))[:n]
        _hold_to_native(L, int(rng.choice(CHUNKS)))


def test_state_does_not_depend_on_the_chunk():
    L = np.stack([_runs_block(range(1, 40)), _runs_block(range(39, 0, -1))])
    heads = [ops_pack.mtf_rle_ref(torch.from_numpy(L), c).head for c in (1, 7, 64, 997, 4096)]
    assert all(torch.equal(h, heads[0]) for h in heads)


def _rows_and_host(L: np.ndarray, chunk: int | None = None):
    """RowPack's payloads of every row of L, and pack_block's."""
    packer = pack.RowPack(torch.from_numpy(L))
    if chunk is not None:
        packer._state = ops_pack.mtf_rle_ref(packer._L, chunk)
    return packer.payloads(list(range(len(L)))), [pack.pack_block(row) for row in L]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_row_pack_matches_pack_block(chunk):
    """Packed rows, a single-symbol row, an incompressible (raw) row and a
    row of one byte, in one batch."""
    n = 3000
    rng = np.random.default_rng(chunk)
    L = np.stack([
        np.frombuffer(zipf_text(n, 5), np.uint8),
        np.resize(_runs_block(range(1, 20)), n),
        np.zeros(n, np.uint8),
        rng.integers(0, 256, n).astype(np.uint8),
    ])
    got, want = _rows_and_host(L, chunk)
    assert got == want
    assert [p[0] for p in got] == [1, 1, 1, 0]
    one = np.array([[42]], np.uint8)
    got, want = _rows_and_host(one, chunk)
    assert got == want and got[0][0] == 0


def test_row_pack_packs_only_the_rows_asked():
    L = np.stack([np.frombuffer(zipf_text(2000, s), np.uint8) for s in range(3)])
    packer = pack.RowPack(torch.from_numpy(L))
    assert packer.payloads([0, 2]) == [pack.pack_block(L[0]), pack.pack_block(L[2])]


def test_plan_stores_a_code_past_32_bits_raw():
    """A Fibonacci histogram over 40 symbols drives Huffman past 32 bits."""
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    hist = np.zeros(ops_pack.NSYM, np.int64)
    hist[2:42] = fib
    _vals, _lens, maxlen = pack._codes_for(np.arange(2, 42), hist[2:42])
    assert maxlen > 32
    assert pack._plan(1 << 40, int(hist.sum()), hist) is None


def test_row_pack_stores_raw_where_the_codes_pass_32_bits(monkeypatch):
    """Both paths take the raw decision from one ``_plan``: with codes
    reported past 32 bits, RowPack copies L back as pack_block stores it."""
    codes_for = pack._codes_for

    def too_long(present, counts):
        vals, lens, _maxlen = codes_for(present, counts)
        return vals, lens, 33

    monkeypatch.setattr(pack, "_codes_for", too_long)
    L = np.stack([np.frombuffer(zipf_text(2500, s), np.uint8) for s in (7, 8)])
    got, want = _rows_and_host(L)
    assert got == want == [b"\x00" + row.tobytes() for row in L]


def _pack_counts(generation: str, on_device: bool, monkeypatch):
    """A unit of 8 rows and a ragged 1-row tail (an incompressible block
    among them) through ``encode_file(pack=True, device="cpu")``, its units
    packed as on a card (the twins, through ``RowPack``) or not: the
    container, held to the host pack's byte for byte (the stream packs every
    L on the host) and to the reference's, and the pack's counters."""
    if on_device:
        monkeypatch.setattr(blocks, "_packs_on_device", lambda L: True)
    block = 2048
    rng = np.random.default_rng(11)
    data = (zipf_text(5 * block, 21) + rng.integers(0, 256, block, dtype=np.uint8).tobytes()
            + zipf_text(2 * block + 777, 22))
    s = pack.stats
    before = (s.blocks, s.raw_blocks, s.device_blocks, s.bytes_in, s.bytes_out)
    got = blocks.encode_file(data, generation, block, impl="micro", pack=True, device="cpu")
    counts = (s.blocks - before[0], s.raw_blocks - before[1], s.device_blocks - before[2],
              s.bytes_in - before[3], s.bytes_out - before[4])
    host = blocks.encode_file(data, generation, block, impl="stream", pack=True, device="cpu")
    assert got == host == ata2.build(data, generation, block, "cpu")
    payloads = [p for _n, p, _base in ata2.parse(got)[1]]
    assert [p[0] for p in payloads] == [1] * 5 + [0] + [1] * 3
    assert blocks.decode_file(got) == data
    return counts, len(data), sum(map(len, payloads))


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_encode_file_packs_on_the_device_path(generation, monkeypatch):
    """Units packed as on a card: every row counted as a device block."""
    counts, n, size = _pack_counts(generation, True, monkeypatch)
    assert counts == (9, 1, 9, n, size)


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_encode_file_on_the_cpu_packs_on_the_host(generation, monkeypatch):
    """Units whose L lies on the CPU pack on the host pool (``pack_block``),
    not through the twins: the same bytes, no device block."""
    monkeypatch.setattr(blocks, "RowPack", None)  # a call would raise
    counts, n, size = _pack_counts(generation, False, monkeypatch)
    assert counts == (9, 1, 0, n, size)


def test_payload_head_is_the_host_layout():
    """The device path writes the head ``_plan`` builds: method 1, m,
    nbits, npresent, the sparse histogram."""
    L = np.frombuffer(zipf_text(5000, 31), np.uint8)
    (got,), (want,) = _rows_and_host(L[None].copy())
    assert got == want
    m, nbits, npresent = struct.unpack_from("<IIH", got, 1)
    syms = native.mtf_rle0(L)
    assert m == len(syms) and npresent == len(np.unique(syms))
    assert len(got) == 11 + 6 * npresent + 4 * ((nbits + 31) // 32)


def test_device_pack_spans_nest_in_dispatch_and_collect(monkeypatch):
    """``archon.pack.launch`` opens inside each unit's dispatch, ``.codes``
    and ``.words`` inside its collect; a file of two units, packed as on a
    card, opens each."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(blocks, "_packs_on_device", lambda L: True)
    data = zipf_text(8 * 2048 + 999, 41)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        blocks.encode_file(data, "a4", 2048, impl="micro", pack=True, device="cpu")
    got = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("archon."):
            got.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))

    def inside(name, outer):
        return all(any(a <= s and e <= b for a, b in got[outer]) for s, e in got[name])

    assert len(got["archon.pack.launch"]) == len(got["archon.pack.codes"]) == 2
    assert inside("archon.pack.launch", "archon.container.dispatch")
    assert inside("archon.pack.codes", "archon.container.collect")
    assert inside("archon.pack.words", "archon.container.collect")
