"""The control of the check: the reference, in the program's place, with the
format's guarantee broken, has to come out not correct.

The guarantee is an exact BWT.  The control sorts suffixes by their first
``harness.CONTROL_DEPTH`` bytes only and leaves deeper ties in position
order (a bounded-context sort: the shortcut a faster sorter would take).  For
each seed it serves every file of the cell's mix once through the control,
holds the containers to the exact reference by the run's own comparison, and
prints the numbers compared beside their limits.  The benchmark's runs never
run it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Control:
    """An adapter whose containers come from the bounded-context reference."""

    def __init__(self, adapter, depth: int):
        self.inner, self.depth = adapter, depth
        self.diff, self.summary = adapter.diff, adapter.summary

    def encode(self, data: bytes) -> bytes:
        return self.inner.reference(data, self.depth)

    def reference(self, data: bytes) -> bytes:
        return self.inner.reference(data)


def control_checks(workload: str, seed: int, device, scale: int = 1, call: dict | None = None) -> dict:
    """The checks of one seed's control run: {name: {value, limit}}."""
    from portbench import harness

    cell = harness.find_cell(harness.load_benchmark(), workload)
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    adapter = harness.load_adapter(config["entry"]).Adapter({**config["call"], **(call or {})}, device)
    files = harness.load_generator(traffic["generator"]).make(traffic, seed, scale)
    control = Control(adapter, harness.CONTROL_DEPTH)
    answers = harness.Answers(control, len(files), seed)
    for k, (_name, data) in enumerate(files):
        answers.add(k, control.encode(data))
    checks, failed = harness.compare(control, files, answers)
    return {"checks": checks, "failed": failed, "requests": len(files),
            "correct": all(c["value"] <= c["limit"] for c in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import CONTROL_DEPTH

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = control_checks(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_depth": CONTROL_DEPTH,
                          "seconds": time.perf_counter() - t, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
