"""No module the harness loads is JAX's or the JAX package's, and the
reference loads nothing of the program.  Each check runs in a fresh
interpreter; top-level names are compared whole (the program's name begins
with the JAX package's)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "archon_tpu"}


def _top_levels(code: str, cwd=ROOT) -> set:
    env = {**os.environ, "PYTHONPATH": str(cwd)}
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=cwd, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    tops = _top_levels("import portbench.reference.bwt, portbench.reference.ata1, portbench.reference.atm1")
    assert not tops & (FORBIDDEN | {"archon_tpu_torch"})


def test_harness_and_a_whole_run_load_no_jax():
    code = ("import portbench.harness, portbench.trace, portbench.control, portbench.adapters.encode_file, "
            "portbench.adapters.encode_megablock\n"
            "from portbench import harness\n"
            "r = harness.run('atm1_sp8.enwik8_text', 3, 0.05, True, 'cpu', scale=100000)\n"
            "r = harness.run('a4_micro.canterbury_small', 3, 0.05, False, 'cpu', scale=256,"
            " call={'block_size': 4096})\n"
            "assert r['correct'] and harness.forbidden_modules() == []")
    tops = _top_levels(code)
    assert "archon_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "a4_micro.silesia_text",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "a4_micro.silesia_text",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
