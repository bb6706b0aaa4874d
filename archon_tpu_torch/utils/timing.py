"""Stage timing / tracing (SURVEY.md section 5 observability parity; port of
``archon_tpu/utils/timing.py``).

The reference wraps every stage in clock() spans and prints per-stage times
plus derived metrics (a4 printime, a4/src/main.c:9-14; a5's per-stage
"Stage k" report and "Linear coef" ms/MB, a5/src/archon.c:161-192; a6's
transform-vs-IO split, a6/src/main.c:160-174).  ``StageTimer`` reproduces
that reporting; ``profile_trace`` wraps ``torch.profiler`` for a trace of
the host operators and the device kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class StageTimer:
    """Collects named stage durations; prints an a4/a5-style report.  A
    stage's clock stops only after the CUDA device, when one is in use, has
    finished the work the stage enqueued."""

    def __init__(self, total_bytes: int = 0):
        self.stages: list[tuple[str, float]] = []
        self.total_bytes = total_bytes
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.stages.append((name, time.perf_counter() - t))

    def report(self, out=print):
        total = time.perf_counter() - self._t0
        for name, dt in self.stages:
            out(f"{name} time: {dt:.3f} sec")
        out(f"Total time: {total:.3f} sec")
        if self.total_bytes:
            mb = self.total_bytes / 1e6
            out(f"Linear coef: {total * 1e3 / max(mb, 1e-9):.2f} ms/MB "
                f"({mb / max(total, 1e-9):.1f} MB/s)")


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` trace around a region (CPU activity, and CUDA
    activity when a card is present), written as a Chrome trace
    ``archon_trace_<pid>.json`` into ``logdir``; a no-op when ``logdir`` is
    empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"archon_trace_{os.getpid()}.json"))
