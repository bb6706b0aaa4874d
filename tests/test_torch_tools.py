"""The port's host modules (utils/corpus, ops/itn, ops/sais, entropy/coder,
golden/a6, utils/tools) against the JAX package's: same inputs, equal
outputs.  Then the port's own utilities: ``memory_report``, ``StageTimer``,
``profile_trace``, ``checked``, ``poison_check``.
"""

import json
import os

import numpy as np
import pytest
import torch

from archon_tpu.entropy import coder as jcoder
from archon_tpu.entropy import huffman as jhuffman
from archon_tpu.golden import a6 as ja6
from archon_tpu.ops import itn as jitn
from archon_tpu.ops import sais as jsais
from archon_tpu.utils import corpus as jcorpus
from archon_tpu.utils import tools as jtools
from archon_tpu_torch.entropy import coder, huffman
from archon_tpu_torch.golden import a6, sa as golden
from archon_tpu_torch.ops import itn, sais
from archon_tpu_torch.ops import sort as tsort
from archon_tpu_torch.utils import corpus, debug, timing, tools

TEXT = np.frombuffer(jcorpus.text_like(6000, seed=21), np.uint8)


def test_corpus_generators_are_byte_identical(monkeypatch, tmp_path):
    for n in (0, 1, 100, 5000):
        for seed in (0, 7):
            assert corpus.text_like(n, seed=seed) == jcorpus.text_like(n, seed=seed)
            assert corpus.markup_like(n, seed=seed) == jcorpus.markup_like(n, seed=seed)
        assert corpus.fibonacci_string(n) == jcorpus.fibonacci_string(n)
    for n in (64, 997, 4096):
        assert corpus.gauntlet_cases(n) == jcorpus.gauntlet_cases(n)
    monkeypatch.delenv("ARCHON_CORPUS", raising=False)
    monkeypatch.setenv("ARCHON_CORPUS_STYLE", "markup")
    assert corpus.load_or_synthesize(300) == ("synthetic-markup", corpus.markup_like(300))
    real = tmp_path / "enwik8"
    real.write_bytes(b"real corpus bytes" * 10)
    monkeypatch.setenv("ARCHON_CORPUS", str(real))
    assert corpus.load_or_synthesize(20) == ("enwik8", (b"real corpus bytes" * 10)[:20])


@pytest.mark.parametrize("order", [2, 3, 4])
def test_itn_matches(order):
    assert np.array_equal(itn.it_masks(TEXT, order), jitn.it_masks(TEXT, order))
    assert np.array_equal(itn.estimate_masks(TEXT, order), jitn.estimate_masks(TEXT, order))
    assert np.array_equal(itn.it2_lucky(TEXT), jitn.it2_lucky(TEXT))
    assert itn.split_fractions(TEXT, order) == jitn.split_fractions(TEXT, order)
    small = TEXT[:700]
    assert itn.wave_counts(small) == jitn.wave_counts(small)
    got = itn.itoh_tanaka_sa(small)
    assert np.array_equal(got, jitn.itoh_tanaka_sa(small))
    assert np.array_equal(got, golden.suffix_array(small, "small"))


def test_host_sais_matches():
    rng = np.random.default_rng(4)
    for arr in (TEXT[:900], rng.integers(0, 3, 500, dtype=np.uint8),
                np.frombuffer(b"mississippi", np.uint8), np.frombuffer(b"a", np.uint8)):
        got = sais.sais(arr)
        assert np.array_equal(got, jsais.sais(arr))
        assert np.array_equal(got, golden.suffix_array(arr, "small"))


@pytest.mark.parametrize("config", ["byte", "fix", "var"])
def test_coder_and_golden_a6_match(config):
    data = TEXT[:2000]
    codes = a6._build_codes(data, config)
    jcodes = ja6._build_codes(data, config)
    assert [(c.code, c.length) for c in codes] == [(c.code, c.length) for c in jcodes]
    stream, ends, total = coder.encode_stream(data, codes)
    jstream, jends, jtotal = jcoder.encode_stream(data, jcodes)
    assert np.array_equal(stream, jstream) and np.array_equal(ends, jends) and total == jtotal
    assert np.array_equal(coder.bits_of_stream(stream, total), jcoder.bits_of_stream(jstream, jtotal))
    assert np.array_equal(coder.decode_stream(stream, total, codes, len(data)), data)
    blob = a6.a6_encode(data.tobytes(), config)
    assert blob == ja6.a6_encode(data.tobytes(), config)
    assert a6.a6_decode(blob, config) == ja6.a6_decode(blob, config) == data.tobytes()
    assert huffman.build_encoder_var is not jhuffman.build_encoder_var  # the port's own copy


def test_tools_match():
    small = TEXT[:1500]
    for order in (2, 3):
        assert tools.estimate_it_groups(small, order) == jtools.estimate_it_groups(small, order)
    assert tools.huffman_bits_per_sym(small) == jtools.huffman_bits_per_sym(small)
    assert tools.varadix_orders(small) == jtools.varadix_orders(small)
    assert tools.varadix_orders(np.zeros(10, np.uint8)) == jtools.varadix_orders(np.zeros(10, np.uint8))
    assert tools.route_search(2) == jtools.route_search(2)
    assert tools._route_volumes(3) == jtools._route_volumes(3)
    assert tools._route_links(3) == jtools._route_links(3)
    bench = tools.radix_direction_bench(size=1 << 10, iters=4)
    assert set(bench) == {"ascending_s", "descending_s"} and min(bench.values()) > 0


def test_reorder_direct_volume_matches():
    small = TEXT[:800]
    assert tools.reorder_direct_volume(small) == jtools.reorder_direct_volume(small)


@pytest.mark.parametrize("impl", ["v3", "doubling"])
def test_memory_report_counts_the_ports_tensors(impl):
    n = 1 << 20
    rep = tools.memory_report(n, impl)
    parts = {k: v for k, v in rep.items() if k not in ("bytes_per_input_byte", "total_bytes")}
    assert {"rank_padded", "key_matrix", "iota", "tuple_buffer", "pingpong_buffer"} <= set(parts)
    assert rep["bytes_per_input_byte"] == sum(parts.values())
    assert rep["total_bytes"] == rep["bytes_per_input_byte"] * n
    # the tuple buffers hold the carried keys and the index (ops/sort.py)
    assert rep["tuple_buffer"] == rep["pingpong_buffer"] == 4 * (tsort.MAX_CARRY + 1)
    assert tools.memory_report(n, "v3")["total_bytes"] > tools.memory_report(n, "doubling")["total_bytes"]
    with pytest.raises(ValueError):
        tools.memory_report(n, "v9")


def test_stage_timer_report_lines():
    timer = timing.StageTimer()
    for name in ("Read", "Transform", "Write"):
        with timer.stage(name):
            pass
    timer.total_bytes = 4_000_000
    lines = []
    timer.report(lines.append)
    assert [ln.split(" time:")[0] for ln in lines[:4]] == ["Read", "Transform", "Write", "Total"]
    assert all(ln.endswith(" sec") for ln in lines[:4])
    assert lines[4].startswith("Linear coef: ") and "ms/MB" in lines[4] and "MB/s)" in lines[4]
    quiet = []
    timing.StageTimer().report(quiet.append)
    assert len(quiet) == 1  # no bytes, no coefficient


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(None):
        pass
    with timing.profile_trace(""):
        pass
    assert not list(tmp_path.iterdir())
    logdir = tmp_path / "prof"
    with timing.profile_trace(str(logdir)):
        tsort.sort_operands((torch.arange(100, dtype=torch.int32).flip(0),))
    (trace,) = logdir.iterdir()
    assert trace.name == f"archon_trace_{os.getpid()}.json" and trace.stat().st_size > 0
    assert json.loads(trace.read_text())["traceEvents"]


def test_checked_raises_on_an_out_of_range_index():
    def ranks(n, bad=None):
        r = torch.arange(n, dtype=torch.int32)
        if bad is not None:
            r[0] = bad
        return r, (torch.tensor([0.5]), [r.clone()]), torch.tensor([True])

    safe = debug.checked(ranks, 0, 8)
    assert safe(8)[0].tolist() == list(range(8))
    assert safe.__name__ == "ranks"
    for bad in (8, -1):
        with pytest.raises(IndexError, match="ranks"):
            safe(8, bad)
    assert debug.checked(lambda: torch.zeros(0, dtype=torch.int32), 0, 0)().numel() == 0


def test_cpu_tensors_take_the_twins_and_nothing_switches_the_route(monkeypatch):
    """Inspection without the kernels is a matter of the tensors' device: the
    wrappers hand CPU operands to their twins, and neither the sort module
    nor the debug module holds a switch that would do so on a card."""
    keys = (torch.tensor([3, 1, 2], dtype=torch.int32),)
    assert tsort.sort_operands(keys)[0].tolist() == [1, 2, 3]
    assert tsort.sort_rows((keys[0][None],))[0].tolist() == [[1, 2, 3]]
    seen = []
    monkeypatch.setattr(tsort, "sort_operands_ref", lambda k, p: seen.append("operands") or k + p)
    monkeypatch.setattr(tsort, "sort_rows_ref", lambda k, p: seen.append("rows") or k + p)
    tsort.sort_operands(keys)
    tsort.sort_rows((keys[0][None],))
    assert seen == ["operands", "rows"]
    assert not hasattr(debug, "interpret_mode") and not hasattr(tsort, "_INTERPRET")


def test_poison_check():
    debug.poison_check(np.arange(5))
    debug.poison_check(torch.arange(5))
    with pytest.raises(AssertionError, match="rank: 2 poison"):
        debug.poison_check(torch.tensor([0, -1, 3, -1]), name="rank")
