"""The compressing container, ATA2 (``encode_file(..., pack=True)``), against
the benchmark's plain reference (``portbench/reference/ata2.py``), and the
pack's span and counters (``archon.pack.blocks``, ``entropy.pack.stats``).

Everything runs on the CPU (``device="cpu"``: the sorts take their plain
twins); the benchmark's cell ``a4_micro_pack.silesia_text`` holds the card's
containers to the same reference.
"""

import json
import os
import struct
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from archon_tpu_torch import native
from archon_tpu_torch.entropy import pack
from archon_tpu_torch.io import blocks
from portbench.gen.zipf_text import zipf_text
from portbench.reference import ata2

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 1 << 14


def _payloads(blob: bytes) -> list[bytes]:
    return [p for _n, p, _base in ata2.parse(blob)[1]]


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_encode_file_pack_equals_the_reference(generation):
    """Three whole blocks of Zipf text and a ragged tail, byte for byte."""
    data = zipf_text(3 * BLOCK + 5_001, 2**31 + 17)
    got = blocks.encode_file(data, generation, BLOCK, verify=True, impl="micro", pack=True, device="cpu")
    want = ata2.build(data, generation, BLOCK, "cpu")
    assert got == want
    assert ata2.diff(got, want) == {"header": 0, "frame_n": 0, "frame_payload": 0, "frame_base": 0}
    assert [p[0] for p in _payloads(got)] == [1, 1, 1, 1]
    assert blocks.decode_file(got) == data


def _ranks_then_runs(L: np.ndarray) -> np.ndarray:
    return ata2.rle0(ata2.mtf_ranks(torch.from_numpy(L))).numpy()


@pytest.mark.parametrize("lengths", [
    list(range(1, 71)),
    [(1 << k) + d for k in range(2, 17) for d in (-1, 1)],
], ids=["1-70", "2^k+-1"])
def test_reference_mtf_rle0_equals_the_native(lengths):
    """Zero runs of each length: of the first symbol, after a change of
    symbol, and at the end of the block."""
    for k in lengths:
        L = np.array([9] * k + [200, 9] + [200] * k + [3] + [3] * k, np.uint8)
        assert np.array_equal(_ranks_then_runs(L), native.mtf_rle0(L).astype(np.int64)), k


def test_reference_mtf_rle0_equals_the_native_on_random_blocks():
    rng = np.random.default_rng(2**31 + 5)
    for _ in range(40):
        n = int(rng.integers(1, 4000))
        L = rng.integers(0, int(rng.integers(1, 257)), n).astype(np.uint8)
        L = np.repeat(L, rng.integers(1, 12, n))[:n]
        assert np.array_equal(_ranks_then_runs(L), native.mtf_rle0(L).astype(np.int64))


@pytest.mark.parametrize("case, method", [
    ("random bytes", 0),
    ("empty", 0),
    ("short single-symbol run", 0),  # its zero-length code's head is longer than the block
    ("long single-symbol run", 1),
])
def test_edge_payloads_equal_the_reference(case, method):
    L = {
        "random bytes": np.random.default_rng(3).integers(0, 256, 5000).astype(np.uint8),
        "empty": np.zeros(0, np.uint8),
        "short single-symbol run": np.zeros(15, np.uint8),  # 15 zeros: RUNA x 4
        "long single-symbol run": np.zeros((1 << 12) - 1, np.uint8),  # RUNA x 12
    }[case]
    got = pack.pack_block(L)
    assert got == ata2.payload(L)
    assert got[0] == method
    if method == 1:
        m, nbits, npresent = struct.unpack_from("<IIH", got, 1)
        assert (m, nbits, npresent) == (12, 0, 1) and len(got) == 17
    assert np.array_equal(pack.unpack_block(got, len(L)), L)


def test_stats_count_a_known_encode():
    """Two blocks of random bytes (stored raw) and one of text, and the
    method bytes counted with the payloads."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 2 * BLOCK, dtype=np.uint8).tobytes() + zipf_text(BLOCK - 999, 4)
    s = pack.stats
    before = (s.blocks, s.raw_blocks, s.bytes_in, s.bytes_out, s.ns)
    blob = blocks.encode_file(data, "a4", BLOCK, impl="micro", pack=True, device="cpu")
    payloads = _payloads(blob)
    assert [p[0] for p in payloads] == [0, 0, 1]
    assert s.blocks - before[0] == 3 and s.raw_blocks - before[1] == 2
    assert s.bytes_in - before[2] == len(data)
    assert s.bytes_out - before[3] == sum(map(len, payloads)) == len(blob) - 12 - 3 * 12
    assert s.ns > before[4]


def test_stats_lose_no_update_under_racing_threads():
    """More threads than cores pack at once, with the interpreter switching
    threads every microsecond: every block and byte is counted."""
    rng = np.random.default_rng(12)
    items = [rng.integers(0, 1 + i % 7, 64 + i, dtype=np.uint8) for i in range(400)]
    s = pack.stats
    before = (s.blocks, s.bytes_in, s.bytes_out)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 1)) as ex:
            out = list(ex.map(pack.pack_block, items, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert s.blocks - before[0] == len(items)
    assert s.bytes_in - before[1] == sum(map(len, items))
    assert s.bytes_out - before[2] == sum(map(len, out))
    assert not any(t.name.startswith("ThreadPoolExecutor") and t.is_alive() for t in threading.enumerate())


def _spans_of(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("archon."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_pack_span_opens_inside_the_frames_span(tmp_path):
    data = zipf_text(2 * BLOCK + 77, 5)
    got = _spans_of(lambda: blocks.encode_file(data, "a4", BLOCK, impl="micro", pack=True, device="cpu"))
    (pack_span,) = got["archon.pack.blocks"]
    assert any(a <= pack_span[0] and pack_span[1] <= b for a, b in got["archon.container.frames"])
    plain = _spans_of(lambda: blocks.encode_file(data, "a4", BLOCK, impl="micro", pack=False, device="cpu"))
    assert "archon.pack.blocks" not in plain
    path = tmp_path / "out.ata2"
    got = _spans_of(lambda: blocks.encode_to_path(data, path, "a4", BLOCK, pack=True, device="cpu"))
    assert "archon.pack.blocks" in got
    assert path.read_bytes() == ata2.build(data, "a4", BLOCK, "cpu")


def test_reference_loads_nothing_of_the_program():
    code = ("import portbench.reference.ata2, sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)}, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"archon_tpu_torch", "archon_tpu", "jax", "jaxlib", "flax"}
