"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix or metric lives in
a file of its own, found by name:

- ``configs/<config>.json``: the deployment; ``entry`` names the adapter
  (``adapters/<entry>.py``) and ``call`` holds its arguments;
- ``traffic/<mix>.json``: ``generator`` names a module of ``gen/`` whose
  ``make(traffic, seed, scale)`` returns the files one client sends, in order;
- ``metrics/<metric>.py``: ``read(window)`` returns the number or None, and
  ``COUNTERS`` names the program's counters it reads (``module:attr.attr``).

A cell ``<config>.<mix>`` is one entry of ``workloads`` in BENCHMARK.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "archon_tpu")
CONTROL_DEPTH = 16  # the control's bounded-context sort: ties past 16 bytes stay in position order
KEEP = 2  # whole containers kept of each file of the mix, drawn from the seed


@dataclass
class Window:
    """What the measured window saw; the metric readers read this."""

    setup_s: float = 0.0
    window_s: float = 0.0
    requests: int = 0
    bytes_in: int = 0
    rows: int = 0
    latencies_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    trace: object = None


class Answers:
    """What the window returned.  Of every request the summary of its
    container (``adapter.summary``: the header, the lengths and bases), or
    None where it raised; of each file, ``keep`` whole containers drawn
    uniformly from its requests by a reservoir seeded from the run's seed.
    Keeping every container would hold gigabytes on the host and make the
    allocator fault in fresh pages inside the window."""

    def __init__(self, adapter, n_files: int, seed: int, keep: int = KEEP):
        self.adapter, self.keep = adapter, keep
        self.rng = random.Random(seed)
        self.summaries = []  # (file index, summary or None) per request
        self.seen = [0] * n_files
        self.kept = [[] for _ in range(n_files)]  # (request index, container) per file

    def add(self, k: int, blob: bytes | None) -> None:
        i = len(self.summaries)
        self.summaries.append((k, None if blob is None else self.adapter.summary(blob)))
        if blob is None:
            return
        self.seen[k] += 1
        if len(self.kept[k]) < self.keep:
            self.kept[k].append((i, blob))
        else:
            j = self.rng.randrange(self.seen[k])
            if j < self.keep:
                self.kept[k][j] = (i, blob)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_adapter(entry: str):
    return importlib.import_module(f"portbench.adapters.{entry}")


def load_generator(name: str):
    return importlib.import_module(f"portbench.gen.{name}")


def load_reader(metric: str):
    """The reader module of one metric (file names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_counter(path: str) -> int:
    mod_name, attrs = path.split(":")
    obj = importlib.import_module(mod_name)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", t0: float | None = None,
        bench: dict | None = None, scale: int = 1, call: dict | None = None) -> dict:
    """One run of ``workload``.  Returns the result object of the last line
    (with ``checks`` last), without printing it.  ``scale`` and ``call`` let
    the tests run a cell small on the CPU: sizes are divided by ``scale`` and
    ``call`` replaces entries of the configuration's call."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    on_card = torch.device(device).type == "cuda"
    bench = load_benchmark() if bench is None else bench
    cell = find_cell(bench, workload)
    config = load_config(cell["config"])
    traffic = load_traffic(cell["traffic"])
    entry = load_adapter(config["entry"])
    adapter = entry.Adapter({**config["call"], **(call or {})}, device)
    files = load_generator(traffic["generator"]).make(traffic, seed, scale)
    metrics = cell_metrics(bench, workload, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    counters = sorted({c for r in readers.values() for c in getattr(r, "COUNTERS", ())})

    for _name, data in files:  # warm-up: every shape the window will use
        adapter.encode(data)
    if on_card:
        torch.cuda.synchronize()

    w = Window()
    answers = Answers(adapter, len(files), seed)
    before = {c: read_counter(c) for c in counters}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as tr

        log = tr.SortLog()
        undo = tr.wrap(list(getattr(entry, "SPANS", ())), log)
        prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
        prof.start()
        window_span = record_function("portbench.window")
        window_span.__enter__()
    w.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        k = i % len(files)
        data = files[k][1]
        t_req = time.perf_counter()
        try:
            if trace:
                with record_function("portbench.request"):
                    blob = adapter.encode(data)
            else:
                blob = adapter.encode(data)
        except Exception as exc:  # a request that fails is counted and the run goes on
            print(f"request {i} ({files[k][0]}) failed: {exc!r}", file=sys.stderr)
            blob = None
        done = time.perf_counter()
        w.latencies_s.append(done - t_req)
        w.bytes_in += len(data)
        w.rows += adapter.rows(data)
        answers.add(k, blob)
        i += 1
    if on_card:
        torch.cuda.synchronize()
    w.window_s = time.perf_counter() - start
    w.requests = i
    if trace:
        window_span.__exit__(None, None, None)
        prof.stop()
        tr.unwrap(undo)
    w.counters = {c: read_counter(c) - before[c] for c in counters}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:
        w.trace = tr.reduce_events(prof.profiler.kineto_results.events(), log)
        del prof

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(w)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the window has closed and the program's memory is freed
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = compare(adapter, files, answers)

    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": w.requests,
        "failed": failed,
        "metrics": values,
        "device": device_info(device, peak),
    }
    if trace:
        result["device"]["busy_s"] = w.trace.busy_s
        result["device"]["window_s"] = w.trace.window_s
        result["breakdown"] = {"device_ops": w.trace.device_ops, "idle_gaps": w.trace.idle_gaps}
        result["trace_counts"] = {"device_events": w.trace.device_events,
                                  "linked_events": w.trace.linked_events,
                                  "sort_calls": w.trace.sort_calls,
                                  "sort_bytes": w.trace.sort_bytes,
                                  "sort_device_s": w.trace.sort_device_s}
    result["checks"] = checks
    return result


def compare(adapter, files, answers: Answers) -> tuple[dict, int]:
    """Hold the window's containers to the reference's container of the
    same file: the kept ones byte for byte, part by part, and the summary of
    every other one.  Returns ({check: {value, limit}}, requests failed): a
    request failed where it raised or where what was kept of it differs."""
    used = sorted({k for k, _ in answers.summaries})
    want = {k: adapter.reference(files[k][1]) for k in used}
    want_summary = {k: adapter.summary(want[k]) for k in used}
    kept = {i for items in answers.kept for i, _ in items}
    raised = bad_summary = 0
    for i, (k, summary) in enumerate(answers.summaries):
        if summary is None:
            raised += 1
        elif i not in kept and summary != want_summary[k]:
            bad_summary += 1
    totals: dict[str, int] = {}
    wrong = 0
    for k, items in enumerate(answers.kept):
        for _i, blob in items:
            counts = adapter.diff(blob, want[k])
            wrong += any(counts.values())
            for part, n in counts.items():
                totals[part] = totals.get(part, 0) + n
    checks = {"requests_raised": {"value": raised, "limit": 0},
              "bad_summary": {"value": bad_summary, "limit": 0}}
    for part, n in totals.items():
        checks[f"bad_{part}"] = {"value": n, "limit": 0}
    return checks, raised + bad_summary + wrong


def device_info(device, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}
