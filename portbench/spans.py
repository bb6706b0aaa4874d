"""The program's own spans in the traced run, reduced beside ``trace``'s summary.

The program opens ``archon.<layer>.<step>`` ranges
(``archon_tpu_torch.utils.timing.span``) whenever a profiler records, so the
traced window holds them beside the ``portbench.*`` ranges of this package.
``reduce_program`` reads those of the thread that opened ``portbench.window``:

- idle time of the card by program layer: each idle gap of the window is cut
  at span boundaries, and each piece goes to the layer of the innermost
  ``archon.*`` span open there, or to ``outside`` where none is;
- device time by the innermost program span open when the work was
  launched: a device event linked to a host op goes by that op's start; an
  unlinked one (the program's ctypes-launched kernels) by its stream
  neighbours, the rule ``trace.sort_device_ns`` uses: the earlier linked
  neighbour's span, else the later one's, else ``unattributed``.  Where
  events overlap, each instant is charged once, so the parts add up to the
  busy time;
- device time of the sort kernels, K1 (``sort_tiles_kernel``) and K2
  (``merge_partition_kernel``, ``merge_level_kernel``).

The harness hands the readers only the summary that ``trace.reduce_events``
returns.  ``install`` puts ``reduce_events`` of this module in its place: the
summary it returns carries ``program`` (a ``Program``), and where the window
holds program spans its ``idle_gaps`` name the innermost span of either kind,
each gap cut at span boundaries as above.  The readers
of the program-span metrics call ``install`` when the harness loads them,
before the window.  A window without program spans (a program that opens
none) gets ``program`` with ``spans`` 0 and its summary unchanged.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from portbench import trace
from portbench.peaks import HBM_BYTES_PER_S

PREFIX = "archon."
OUTSIDE = "outside"  # idle or device time under no program span
UNATTRIBUTED = "unattributed"  # device time of unlinked events with no linked neighbour
K1 = ("sort_tiles_kernel",)
K2 = ("merge_partition_kernel", "merge_level_kernel")
_base = trace.reduce_events  # the accepted reduction, before ``install``


@dataclass
class Program:
    spans: int = 0  # program spans the window's thread opened
    idle_s: dict = field(default_factory=dict)  # layer or OUTSIDE -> idle seconds
    device_s: dict = field(default_factory=dict)  # span, OUTSIDE or UNATTRIBUTED -> device seconds
    k1_device_s: float = 0.0
    k2_device_s: float = 0.0


def layer(name: str) -> str:
    """The layer of a program span: ``archon.<layer>.<step>`` -> ``<layer>``."""
    return name.split(".")[1]


def cut_gaps(gaps, segs) -> dict:
    """Idle ns by label: each gap cut at the segments' boundaries, each piece
    to the label of its segment (``trace.innermost_labels``)."""
    times = [t for t, _ in segs]
    out = defaultdict(int)
    for a, b in gaps:
        i = bisect.bisect_right(times, a) - 1
        t = a
        while t < b:
            nxt = times[i + 1] if i + 1 < len(times) else b
            end = min(max(nxt, t), b)
            out[segs[i][1] if i >= 0 else "(no span)"] += end - t
            t, i = end, i + 1
    return dict(out)


def device_by_span(device, host: dict, segs) -> dict:
    """Device ns by the innermost span open at launch (see the module's
    docstring); ``device`` holds (start, end, name, linked correlation id),
    ``host`` maps a host op's correlation id to its start."""
    times = [t for t, _ in segs]
    events = sorted(device)
    labels = [trace.label_at(segs, times, host[c]) if c > 0 and c in host else None
              for _a, _b, _n, c in events]
    before, last = [], None
    for lab in labels:
        last = lab if lab is not None else last
        before.append(last)
    after, nxt = [None] * len(labels), None
    for i in range(len(labels) - 1, -1, -1):
        nxt = labels[i] if labels[i] is not None else nxt
        after[i] = nxt
    out = defaultdict(int)
    cursor = None
    for (a, b, _n, _c), lab, prev, foll in zip(events, labels, before, after):
        start = a if cursor is None else max(a, cursor)
        if b > start:
            out[lab or prev or foll or UNATTRIBUTED] += b - start
        cursor = b if cursor is None else max(cursor, b)
    return dict(out)


def _named(name: str, parts) -> bool:
    return any(p in name for p in parts)


def reduce_program(events) -> tuple[Program, list]:
    """(the program's spans reduced, the window's idle gaps labelled by the
    innermost span of either kind) of one traced window."""
    window, device, host, ranges = None, [], {}, []
    for e in events:
        kind = trace._kind(e)
        if kind == "kernel":
            device.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
        elif kind in ("cpu_op", "user_annotation"):
            host[e.correlation_id()] = e.start_ns()
            if kind == "user_annotation" and e.name() == "portbench.window":
                window = e
            elif kind == "user_annotation" and e.name().startswith(("portbench.", PREFIX)):
                ranges.append(e)
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    w0, w1, tid = window.start_ns(), window.end_ns(), window.start_thread_id()
    program = [(e.start_ns(), e.end_ns(), e.name()) for e in ranges
               if e.name().startswith(PREFIX) and e.start_thread_id() == tid]
    if not program:
        return Program(), []
    clipped = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device if b > w0 and a < w1]
    _busy, gaps = trace.busy_and_gaps([(a, b) for a, b, _, _ in clipped], w0, w1)
    segs = trace.innermost_labels(program)

    idle = defaultdict(float)
    for label, ns in cut_gaps(gaps, segs).items():
        idle[layer(label) if label.startswith(PREFIX) else OUTSIDE] += ns / 1e9
    on_device = {(label if label.startswith(PREFIX) or label == UNATTRIBUTED else OUTSIDE): ns / 1e9
                 for label, ns in device_by_span(clipped, host, segs).items()}
    k1 = sum(b - a for a, b, n, _ in clipped if _named(n, K1))
    k2 = sum(b - a for a, b, n, _ in clipped if _named(n, K2))

    both = trace.innermost_labels(program + [(e.start_ns(), e.end_ns(), e.name()) for e in ranges
                                             if e.name().startswith("portbench.")])
    per_gap = cut_gaps(gaps, both)
    idle_gaps = [[k, v / 1e9] for k, v in sorted(per_gap.items(), key=lambda kv: -kv[1])]
    return (Program(spans=len(program), idle_s=dict(idle), device_s=on_device, k1_device_s=k1 / 1e9,
                    k2_device_s=k2 / 1e9), idle_gaps[:trace.BREAKDOWN_ENTRIES])


def reduce_events(events, log):
    """``trace.reduce_events``, with the program's spans beside it."""
    events = list(events)
    summary = _base(events, log)
    summary.program, idle_gaps = reduce_program(events)
    if idle_gaps:
        summary.idle_gaps = idle_gaps
    return summary


def install() -> None:
    """Put ``reduce_events`` in the place of ``trace.reduce_events``; a
    second call changes nothing."""
    trace.reduce_events = reduce_events


def program(w) -> Program | None:
    """The window's reduced program spans, or None where the window was not
    traced or the program opened no span in it."""
    p = getattr(w.trace, "program", None)
    return p if p is not None and p.spans else None


def idle_pct(w, name: str) -> float | None:
    """Idle time of the card under the program layer ``name``, in % of the
    window."""
    p = program(w)
    if p is None or not w.trace.window_s:
        return None
    return 100.0 * p.idle_s.get(name, 0.0) / w.trace.window_s


def device_pct(w, name: str) -> float | None:
    """Device time launched under the program span ``name``, in % of the
    card's busy time."""
    p = program(w)
    if p is None or not w.trace.busy_s:
        return None
    return 100.0 * p.device_s.get(name, 0.0) / w.trace.busy_s


def roofline(w, counters: tuple, device_s: str) -> float | None:
    """The bytes the program counter ``counters[0]`` counted over the
    window, at the card's memory rate, over the device seconds the
    ``Program`` field ``device_s`` holds, in %; None without the counter."""
    p = program(w)
    if not counters or p is None or not getattr(p, device_s):
        return None
    return 100.0 * w.counters[counters[0]] / HBM_BYTES_PER_S / getattr(p, device_s)
