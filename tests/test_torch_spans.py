"""The program's spans (``utils.timing.span``) and their reduction in the
benchmark's traced run (``portbench/spans.py``).

The spans are named ``archon.<layer>.<step>``; the benchmark's per-layer
metrics read them by name, so a renamed or lost span fails here.  Everything
runs on the CPU (``device="cpu"``: the sorts take their plain twins); the
byte counters of K1 and K2 bump only on the card and are held to their
formula in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from archon_tpu_torch.io import blocks
from archon_tpu_torch.parallel.blocks import make_mesh
from archon_tpu_torch.parallel.megapipe import encode_megablock
from archon_tpu_torch.utils import timing
from archon_tpu_torch.utils.corpus import text_like
from portbench import harness, spans, trace
from portbench.adapters import encode_file as encode_file_adapter
from portbench.adapters import encode_megablock as encode_megablock_adapter

BLOCK = 8192


def _spans_of(fn) -> dict:
    """{span name: [(start, end), ...]} of the program spans ``fn()`` opens."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("archon."):
            out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def _inside(got: dict, child: str, parents) -> bool:
    """Every ``child`` span lies within a span named in ``parents``."""
    outer = [iv for p in parents for iv in got.get(p, [])]
    return all(any(a <= c and d <= b for a, b in outer) for c, d in got[child])


def test_span_is_one_shared_no_op_without_a_profiler():
    assert not torch._C._autograd._profiler_enabled()
    assert timing.span("archon.container.split") is timing.span("archon.batched.round")
    with timing.span("archon.x"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.span("archon.x") is not timing.span("archon.x")


def test_encode_file_spans_nest_as_the_layers_do():
    """Two blocks: one that leaves the batched program for the fallback (a
    250-byte string planted twice: few actives, too deep for the micro
    tail), and a ragged tail of period 2, which takes full rounds; every
    container and batched span, each inside its caller's."""
    rng = np.random.default_rng(5)
    planted = rng.integers(0, 256, BLOCK, dtype=np.uint8)
    rep = rng.integers(0, 256, 250, dtype=np.uint8)
    planted[500:750] = rep
    planted[4096:4346] = rep
    data = planted.tobytes() + b"ab" * 2500
    calls = blocks._fallback_row.calls
    got = _spans_of(lambda: blocks.encode_file(data, "a4", BLOCK, impl="micro", device="cpu"))
    assert blocks._fallback_row.calls == calls + 1
    container = {f"archon.container.{s}" for s in ("split", "stage_in", "dispatch", "collect", "fallback", "frames")}
    batched = {f"archon.batched.{s}" for s in ("bootstrap", "round", "micro_tail", "emit", "certificate")}
    assert container | batched <= set(got)
    top = ("archon.container.split", "archon.container.dispatch", "archon.container.collect",
           "archon.container.frames")
    assert all(not _inside(got, s, [t for t in top if t != s]) for s in top)
    assert _inside(got, "archon.container.fallback", ["archon.container.collect"])
    assert _inside(got, "archon.container.stage_in", ["archon.container.dispatch", "archon.container.fallback"])
    for s in ("bootstrap", "round", "micro_tail", "emit"):
        assert _inside(got, f"archon.batched.{s}", ["archon.container.dispatch"])
    assert _inside(got, "archon.batched.certificate", ["archon.container.dispatch", "archon.container.fallback"])


def test_encode_megablock_spans_nest_as_the_layers_do():
    data = text_like(4096, 9)
    mesh = make_mesh({"sp": 2}, devices=["cpu"] * 2)
    got = _spans_of(lambda: encode_megablock(data, mesh, "a4", "var"))
    names = {f"archon.megablock.{s}" for s in ("init", "local_sort", "round", "stage", "emit", "hist", "pack")}
    assert names == set(got)
    steps = ["archon.megablock.init", "archon.megablock.round", "archon.megablock.emit"]
    assert _inside(got, "archon.megablock.local_sort", steps)
    assert _inside(got, "archon.megablock.stage", steps)
    assert not _inside(got, "archon.megablock.hist", steps) and not _inside(got, "archon.megablock.pack", steps)


def test_trace_wrap_takes_every_adapter_function():
    """No span is a decorator: the layer functions the adapters name carry
    no attributes, and ``trace.wrap`` wraps and restores each."""
    targets = list(encode_file_adapter.SPANS) + list(encode_megablock_adapter.SPANS)
    undo = trace.wrap(targets, trace.SortLog())
    try:
        assert len(undo) >= len(targets)
    finally:
        trace.unwrap(undo)
    assert blocks._batched_forward.__name__ == "_batched_forward" and not vars(blocks._batched_forward)


class Event:
    """The part of the profiler's event that ``trace`` and ``spans`` read."""

    def __init__(self, name, start, end, device="CPU", corr=0, linked=0, annotation=False, thread=1):
        self._name, self._start, self._end, self._device = name, start, end, device
        self._corr, self._linked, self._annotation, self._thread = corr, linked, annotation, thread

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return type("DeviceType", (), {"name": self._device})()

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return self._annotation

    def start_thread_id(self):
        return self._thread


def test_kind_calls_a_device_side_program_span_an_annotation():
    """A program span mirrored on the device, as the card's torch reports it
    (a user annotation on the CUDA timeline): not device work."""
    assert trace._kind(Event("archon.batched.round", 0, 1, "CUDA", annotation=True)) == "gpu_user_annotation"
    assert trace._kind(Event("archon.batched.round", 0, 1, annotation=True)) == "user_annotation"


def _window():
    """A 1000 ns window: a request; in it a dispatch span holding a round
    span, and a collect span; one span on another thread; device work."""
    ann = dict(annotation=True)
    return [
        Event("portbench.window", 0, 1000, corr=1, **ann),
        Event("portbench.request", 0, 950, corr=2, **ann),
        Event("archon.container.dispatch", 100, 400, corr=3, **ann),
        Event("archon.batched.round", 200, 300, corr=4, **ann),
        Event("archon.container.collect", 500, 700, corr=5, **ann),
        Event("archon.batched.emit", 0, 1000, corr=6, thread=2, **ann),  # another thread: not read
        Event("archon.batched.round", 200, 300, "CUDA", **ann),  # mirrored on the device
        Event("aten::stack", 210, 220, corr=7),
        Event("aten::gather", 230, 240, corr=8),
        Event("aten::copy_", 510, 520, corr=9),
        Event("aten::fill_", 50, 60, corr=10),
        Event("fill_kernel", 60, 150, "CUDA", linked=10),  # launched outside every program span
        Event("gather_kernel", 150, 170, "CUDA", linked=7),  # launched under the round
        Event("sort_tiles_kernel<4>", 170, 250, "CUDA"),  # unlinked, between two of the round's
        Event("merge_level_kernel<4>", 250, 270, "CUDA"),
        Event("merge_partition_kernel<4>", 265, 280, "CUDA"),  # overlaps the one before
        Event("index_kernel", 280, 290, "CUDA", linked=8),
        Event("Memcpy DtoH", 600, 650, "CUDA", linked=9),
    ]


def test_program_reduction_of_a_window():
    prog, gaps = spans.reduce_program(_window())
    busy = (290 - 60) + 50
    assert prog.spans == 3
    # idle: [0, 60) outside, [290, 300) round, [300, 400) dispatch, [400, 500)
    # outside, [500, 600) and [650, 700) collect, [700, 1000) outside: a gap
    # that crosses two spans is cut at their boundaries
    assert prog.idle_s == pytest.approx({"outside": 460e-9, "batched": 10e-9, "container": 250e-9})
    assert sum(prog.idle_s.values()) == pytest.approx((1000 - busy) * 1e-9)
    # device: the unlinked K1 and K2 lie between two of the round's events
    assert prog.device_s == pytest.approx({"outside": 90e-9, "archon.batched.round": 140e-9,
                                           "archon.container.collect": 50e-9})
    assert sum(prog.device_s.values()) == pytest.approx(busy * 1e-9)
    assert (prog.k1_device_s, prog.k2_device_s) == (pytest.approx(80e-9), pytest.approx(35e-9))
    assert dict((k, v) for k, v in gaps) == pytest.approx({
        "portbench.request": 410e-9, "archon.container.collect": 150e-9, "archon.container.dispatch": 100e-9,
        "archon.batched.round": 10e-9, "(no span)": 50e-9})


def test_program_metrics_read_the_reduction(monkeypatch):
    """Through ``trace.reduce_events`` as the harness calls it: the layer
    idle shares and the outside share add up to the idle share; the window
    of a program that opens no span reads nothing and keeps its breakdown.
    Loading the readers installs ``spans.reduce_events``; the accepted one
    is put back when the test ends."""
    monkeypatch.setattr(trace, "reduce_events", trace.reduce_events)
    readers = {m: harness.load_reader(m) for m in ("container.idle_pct", "batched.idle_pct",
                                                   "batched.certificate_pct", "megablock.stage_pct",
                                                   "sort.k1_roofline", "sort.k2_roofline", "device.idle_pct")}
    assert trace.reduce_events is spans.reduce_events
    t = trace.reduce_events(_window(), trace.SortLog())
    w = harness.Window(trace=t, counters={"archon_tpu_torch.ops.sort:sort_tiles.bytes": 335,
                                          "archon_tpu_torch.ops.sort:merge_level.bytes": 670})
    got = {m: r.read(w) for m, r in readers.items()}
    outside = 100.0 * t.program.idle_s["outside"] / t.window_s
    assert got["container.idle_pct"] + got["batched.idle_pct"] + outside == pytest.approx(got["device.idle_pct"])
    assert got["batched.certificate_pct"] == 0.0 and got["megablock.stage_pct"] == 0.0
    assert got["sort.k1_roofline"] == pytest.approx(100.0 * 335 / 3.35e12 / 80e-9)
    assert got["sort.k2_roofline"] == pytest.approx(100.0 * 670 / 3.35e12 / 35e-9)
    bare = [e for e in _window() if not e.name().startswith("archon.")]
    t2 = trace.reduce_events(bare, trace.SortLog())
    assert t2.program.spans == 0 and t2.idle_gaps == spans._base(bare, trace.SortLog()).idle_gaps
    assert all(r.read(harness.Window(trace=t2)) is None for m, r in readers.items() if m != "device.idle_pct")


def test_program_metrics_leave_the_accepted_reduction_in_place():
    """The readers' ``spans.install()`` outlives no test: in whichever worker
    this runs, after or without the test above, the accepted reduction is in
    place."""
    assert trace.reduce_events is spans._base
