"""The traced run: host spans from the benchmark's own files, the profiler,
and the reduction of its events to what the per-layer readers read.

Spans: every ``portbench.*`` range is a ``record_function`` opened by this
package, never by the program.  ``portbench.window`` covers the measured
window, ``portbench.request`` one request, ``portbench.sort`` one outermost
call of a sort of the program (``ops.sort.sort_operands``, ``sort_rows``,
``merge_rows``), and ``portbench.<function>`` a call into one of the
layer functions an adapter names.  Functions are wrapped by replacing, in
every loaded module of the program, each attribute that *is* the function,
so ``from .x import f`` sites are covered too; ``unwrap`` puts them back.

Only functions that carry no attributes are wrapped: the program keeps its
counters on function attributes (``_fallback_row.calls``) and bumps them
through the module's global name, which a wrapper would take over.

Device time: the profiler's kernel, memcpy and memset events.  A device event
belongs to the host call that launched it through its linked correlation id.
"""

from __future__ import annotations

import bisect
import importlib
import sys
from collections import defaultdict
from dataclasses import dataclass, field

PACKAGE = "archon_tpu_torch"
SORTS = ("sort_operands", "sort_rows", "merge_rows")
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120  # device op names are cut to this many characters in the breakdown


@dataclass
class SortLog:
    """Bytes the outermost sort calls need: every operand column read once
    and every sorted column written once, each at its own element size."""

    bytes: int = 0
    calls: int = 0
    depth: int = 0


@dataclass
class Summary:
    window_s: float
    busy_s: float
    sort_bytes: int
    sort_calls: int
    sort_device_s: float | None
    device_events: int
    linked_events: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _nbytes(operands) -> int:
    """Bytes of a tensor, or of a sequence of tensors, at their own dtypes."""
    if hasattr(operands, "numel"):
        return operands.element_size() * operands.numel()
    return sum(t.element_size() * t.numel() for t in operands)


def _replace_everywhere(original, replacement) -> list:
    """Point every attribute of a loaded module of the program that is
    ``original`` at ``replacement``; returns the (module, name) pairs."""
    done = []
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or mod_name.split(".")[0] != PACKAGE:
            continue
        for name, value in list(vars(mod).items()):
            if value is original:
                setattr(mod, name, replacement)
                done.append((mod, name, original))
    return done


def wrap(span_targets: list[str], log: SortLog) -> list:
    """Install the sort ranges and the layer spans; returns what ``unwrap``
    needs.  ``span_targets`` are ``module:function`` names."""
    from torch.profiler import record_function

    sort_mod = importlib.import_module(f"{PACKAGE}.ops.sort")
    undo = []

    def sort_wrapper(fn):
        def wrapped(keys, payloads=()):
            if log.depth:
                return fn(keys, payloads)
            log.depth += 1
            try:
                with record_function("portbench.sort"):
                    out = fn(keys, payloads)
            finally:
                log.depth -= 1
            log.bytes += 2 * (_nbytes(keys) + _nbytes(payloads))  # read once, written once
            log.calls += 1
            return out
        return wrapped

    for name in SORTS:
        fn = getattr(sort_mod, name)
        undo += _replace_everywhere(fn, sort_wrapper(fn))

    def span_wrapper(fn, label):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    for target in span_targets:
        mod_name, fn_name = target.split(":")
        fn = getattr(importlib.import_module(mod_name), fn_name)
        if vars(fn):
            unwrap(undo)
            raise ValueError(f"{target} carries attributes {sorted(vars(fn))}; the program updates "
                             "them through its global name, which a span wrapper would replace")
        undo += _replace_everywhere(fn, span_wrapper(fn, f"portbench.{fn_name}"))
    return undo


def unwrap(undo: list) -> None:
    for mod, name, original in reversed(undo):
        setattr(mod, name, original)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_and_gaps(device: list[tuple[int, int]], w0: int, w1: int):
    """(busy ns, idle gaps) of the window [w0, w1]: the union of the device
    intervals clipped to it, and what of the window that union leaves."""
    clipped = [(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1]
    busy = _union(clipped)
    gaps, cursor = [], w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    return sum(b - a for a, b in busy), gaps


def innermost_labels(spans: list[tuple[int, int, str]]):
    """Cut the host timeline into (start, label) segments, each labelled by
    the innermost span open there ("(no span)" where none is)."""
    bounds = []
    for a, b, name in spans:
        bounds.append((a, 1, b, name))
        bounds.append((b, 0, a, name))
    bounds.sort()
    stack, segs = [], []
    for t, is_open, _other, name in bounds:
        if is_open:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        segs.append((t, stack[-1] if stack else "(no span)"))
    return segs


def label_at(segs, times: list[int], t: int) -> str:
    i = bisect.bisect_right(times, t) - 1
    return segs[i][1] if i >= 0 else "(no span)"


def _kind(e) -> str:
    """The event's kind: ``kernel`` (any device activity: kernel, copy,
    fill), ``gpu_user_annotation`` (a range mirrored on the device),
    ``cuda_runtime`` (a host event linked to a device op), ``user_annotation``
    or ``cpu_op``, told apart by the event's device and its link."""
    is_annotation = e.is_user_annotation()
    if e.device_type().name != "CPU":
        return "gpu_user_annotation" if is_annotation or e.name().startswith("portbench.") else "kernel"
    if e.linked_correlation_id() > 0:
        return "cuda_runtime"
    return "user_annotation" if is_annotation else "cpu_op"


def sort_device_ns(device: list, host: dict, sorts: list) -> tuple[int, int]:
    """(device ns of the work the sort calls launched, events linked to a
    host op).  A device event linked to a host op belongs to the sort call
    whose span holds that op's start.  An event with no link (the program's
    own kernels, launched through ctypes, have none) ran on the one stream
    between its neighbours, so it was launched between theirs: it belongs
    to a sort where a neighbour's launch does."""
    sorts = sorted(sorts)
    starts = [a for a, _ in sorts]

    def in_sort(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= sorts[i][1]

    state = []  # per device event in device order: True/False, None where unlinked
    events = sorted(device)
    for _a, _b, _name, corr in events:
        launched = host.get(corr) if corr > 0 else None
        state.append(None if launched is None else in_sort(launched))
    linked = sum(s is not None for s in state)
    if not linked:
        return 0, 0
    total, prev, pending = 0, False, []
    for (a, b, _name, _corr), s in zip(events, state):
        if s is None:
            pending.append(b - a)
            continue
        if pending and (prev or s):
            total += sum(pending)
        pending = []
        total += (b - a) if s else 0
        prev = s
    if pending and prev:
        total += sum(pending)
    return total, linked


def reduce_events(events, log: SortLog) -> Summary:
    """Reduce the profiler's events of one traced window."""
    window = None
    spans, sorts, host = [], [], {}
    device = []  # (start, end, name, linked correlation id)
    for e in events:
        kind = _kind(e)
        if kind == "kernel":
            device.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
            continue
        if kind not in ("cpu_op", "user_annotation"):
            continue
        host[e.correlation_id()] = e.start_ns()
        name = e.name()
        if kind == "user_annotation" and name.startswith("portbench."):
            interval = (e.start_ns(), e.end_ns(), name)
            if name == "portbench.window":
                window = interval
            else:
                spans.append(interval)
                if name == "portbench.sort":
                    sorts.append(interval[:2])
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    w0, w1 = window[0], window[1]
    busy_ns, gaps = busy_and_gaps([(a, b) for a, b, _, _ in device], w0, w1)

    sort_ns, linked = sort_device_ns(device, host, sorts)
    per_op = defaultdict(int)
    for a, b, name, _ in device:
        if b > w0 and a < w1:
            per_op[name[:NAME_CHARS]] += min(b, w1) - max(a, w0)
    segs = innermost_labels(spans)
    times = [t for t, _ in segs]
    per_gap = defaultdict(int)
    for a, b in gaps:
        per_gap[label_at(segs, times, (a + b) // 2)] += b - a

    def top(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    return Summary(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, sort_bytes=log.bytes, sort_calls=log.calls,
        sort_device_s=sort_ns / 1e9 if linked else None, device_events=len(device),
        linked_events=linked, device_ops=top(per_op), idle_gaps=top(per_gap))
