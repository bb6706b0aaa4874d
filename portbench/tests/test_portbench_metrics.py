"""The metric arithmetic: the window's rate, the nearest-rank p95, the idle
share from a union of intervals, the sort's byte count, and the readers."""

import pytest
import torch

from portbench import harness, trace
from portbench.harness import Window


def reader(name):
    return harness.load_reader(name)


def test_rate_counts_the_last_request_with_its_time():
    # 3 requests of 100 MB; the last ends at 31.5 s of a 30 s window
    w = Window(window_s=31.5, requests=3, bytes_in=300_000_000)
    assert reader("encode_MBps").read(w) == pytest.approx(300 / 31.5)
    assert reader("encode_MBps").read(Window()) is None


def test_nearest_rank_p95():
    p95 = reader("encode_p95_ms")
    assert p95.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert p95.nearest_rank(list(range(1, 21)), 0.95) == 19
    assert p95.nearest_rank([5.0], 0.95) == 5.0
    assert p95.read(Window(latencies_s=[x / 1000 for x in range(100, 0, -1)])) == pytest.approx(95.0)
    assert p95.read(Window()) is None


def test_idle_is_one_minus_the_union():
    # overlapping and nested device intervals inside a 100 ns window [0, 100)
    busy, gaps = trace.busy_and_gaps([(10, 30), (20, 40), (25, 35), (60, 70), (95, 120), (-5, 2)], 0, 100)
    assert busy == 2 + 30 + 10 + 5
    assert gaps == [(2, 10), (40, 60), (70, 95)]
    t = trace.Summary(window_s=100e-9, busy_s=busy * 1e-9, sort_bytes=0, sort_calls=0,
                      sort_device_s=None, device_events=6, linked_events=0)
    assert reader("device.idle_pct").read(Window(trace=t)) == pytest.approx(53.0)
    assert reader("device.idle_pct").read(Window()) is None


def test_gap_labels_are_the_innermost_span():
    segs = trace.innermost_labels([(0, 100, "portbench.request"), (10, 20, "portbench.sort"),
                                   (30, 60, "portbench._fallback_row"), (40, 50, "portbench.sort")])
    times = [t for t, _ in segs]
    assert trace.label_at(segs, times, 15) == "portbench.sort"
    assert trace.label_at(segs, times, 25) == "portbench.request"
    assert trace.label_at(segs, times, 35) == "portbench._fallback_row"
    assert trace.label_at(segs, times, 45) == "portbench.sort"
    assert trace.label_at(segs, times, 55) == "portbench._fallback_row"
    assert trace.label_at(segs, times, 150) == "(no span)"


def test_sort_bytes_count_each_operand_once_each_way():
    """Each operand column is read once and written once at its own element
    size: the certificate's sort carries a uint8 payload beside int32 keys."""
    from archon_tpu_torch.ops import sort as sort_mod

    log = trace.SortLog()
    undo = trace.wrap([], log)
    try:
        keys = [torch.randint(0, 9, (1000,), dtype=torch.int32) for _ in range(3)]
        payload = torch.arange(1000, dtype=torch.int32)
        sort_mod.sort_operands(keys, [payload])
        rows = torch.randint(0, 9, (2, 4, 500), dtype=torch.int32)
        sort_mod.sort_rows(list(rows), [])
        key = torch.randint(0, 9, (3, 700), dtype=torch.int32)
        sort_mod.sort_rows((key,), (torch.randint(0, 255, (3, 700), dtype=torch.uint8), torch.zeros(3, 700)))
    finally:
        trace.unwrap(undo)
    assert log.calls == 3
    assert log.bytes == 2 * (4 * 4 * 1000) + 2 * (4 * 2 * 4 * 500) + 2 * (4 + 1 + 4) * 3 * 700
    assert sort_mod.sort_operands.__name__ == "sort_operands"  # unwrapped


def test_wrap_refuses_a_function_that_counts_on_itself():
    from archon_tpu_torch.io import blocks

    log = trace.SortLog()
    with pytest.raises(ValueError, match="calls"):
        trace.wrap(["archon_tpu_torch.io.blocks:_fallback_row"], log)
    from archon_tpu_torch.ops import sort as sort_mod

    assert sort_mod.sort_rows.__name__ == "sort_rows"  # what was wrapped before is put back
    assert blocks._fallback_row.__name__ == "_fallback_row"


class Event:
    """The part of the profiler's event that ``trace`` reads."""

    def __init__(self, name, start, end, device="CPU", corr=0, linked=0, annotation=False):
        self._name, self._start, self._end = name, start, end
        self._device, self._corr, self._linked, self._annotation = device, corr, linked, annotation

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


def test_kind_tells_events_apart():
    assert trace._kind(Event("sort_tiles_kernel<4>", 0, 1, "CUDA", linked=0)) == "kernel"
    assert trace._kind(Event("Memcpy DtoH", 0, 1, "CUDA", linked=5)) == "kernel"
    assert trace._kind(Event("portbench.sort", 0, 1, "CUDA")) == "gpu_user_annotation"
    assert trace._kind(Event("cudaLaunchKernel", 0, 1, linked=5)) == "cuda_runtime"
    assert trace._kind(Event("portbench.window", 0, 1, annotation=True)) == "user_annotation"
    assert trace._kind(Event("aten::sort", 0, 1, corr=5)) == "cpu_op"


def test_reduce_events_of_a_window():
    """A window of 1000 ns: one request, a sort inside it whose op launched a
    kernel, an unlinked kernel right after (the program's ctypes launches),
    and a kernel of an op outside the sort."""
    events = [
        Event("portbench.window", 0, 1000, annotation=True, corr=1),
        Event("portbench.request", 0, 900, annotation=True, corr=2),
        Event("portbench.sort", 50, 300, annotation=True, corr=3),
        Event("aten::sort", 60, 90, corr=7),
        Event("cudaLaunchKernel", 70, 80, linked=7),
        Event("aten::copy_", 350, 360, corr=8),
        Event("portbench.sort", 50, 300, "CUDA"),  # the range mirrored on the device: not device work
        Event("sortKernel", 150, 250, "CUDA", linked=7),
        Event("merge_level_kernel<4>", 250, 280, "CUDA"),
        Event("Memcpy DtoH", 400, 500, "CUDA", linked=8),
    ]
    log = trace.SortLog(bytes=1000, calls=1)
    t = trace.reduce_events(events, log)
    assert (t.window_s, t.busy_s) == (pytest.approx(1000e-9), pytest.approx(230e-9))
    assert t.sort_device_s == pytest.approx(130e-9) and (t.sort_bytes, t.sort_calls) == (1000, 1)
    assert (t.device_events, t.linked_events) == (3, 2)
    assert t.device_ops == [["sortKernel", pytest.approx(100e-9)], ["Memcpy DtoH", pytest.approx(100e-9)],
                            ["merge_level_kernel<4>", pytest.approx(30e-9)]]
    # idle [0,150) lies in the sort span by its middle; [280,400) and [500,1000) in the request's
    assert t.idle_gaps == [["portbench.request", pytest.approx(620e-9)],
                           ["portbench.sort", pytest.approx(150e-9)]]
    with pytest.raises(RuntimeError, match="window"):
        trace.reduce_events(events[1:], log)


def test_roofline_share():
    t = trace.Summary(window_s=1.0, busy_s=0.5, sort_bytes=int(3.35e9), sort_calls=1,
                      sort_device_s=0.004, device_events=1, linked_events=1)
    assert reader("sort_roofline").read(Window(trace=t)) == pytest.approx(25.0)
    t.sort_device_s = None
    assert reader("sort_roofline").read(Window(trace=t)) is None


def test_counter_readers():
    w = Window(requests=4, rows=50, bytes_in=100 * 2**20, counters={
        "archon_tpu_torch.io.blocks:_fallback_row.calls": 5,
        "archon_tpu_torch.core.batched:stats.host_syncs": 30,
        "archon_tpu_torch.core.doubling:stats.host_syncs": 200,
        "archon_tpu_torch.parallel.megablock:stats.rounds": 8,
        "archon_tpu_torch.ops.sort:sort_tiles.launches": 10,
        "archon_tpu_torch.ops.sort:merge_level.launches": 90})
    assert reader("container.fallback_rows_pct").read(w) == 10.0
    assert reader("batched.syncs_per_MiB").read(w) == 0.3
    assert reader("megablock.rounds").read(w) == 2.0
    assert reader("sort.launches_per_MiB").read(w) == 1.0
    for path in w.counters:  # every counter a reader names exists in the program
        harness.read_counter(path)


def test_unlinked_kernels_take_their_neighbours_sort():
    host = {1: 5, 2: 15, 3: 40}  # op correlation id -> launch time
    sorts = [(10, 30)]  # one sort span on the host
    device = [(100, 110, "before", 1), (110, 120, "tuples", 2), (120, 150, "K1", 0), (150, 160, "K2", 0),
              (160, 170, "after", 3), (170, 175, "stray", 0)]
    # in the sort: "tuples" (linked), K1 and K2 (between it and "after")
    assert trace.sort_device_ns(device, host, sorts) == (10 + 30 + 10, 3)
    assert trace.sort_device_ns([(0, 5, "K1", 0)], host, sorts) == (0, 0)
