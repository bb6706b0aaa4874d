"""The port imports no JAX (checked in a fresh interpreter: this test
process already holds jax, tests/conftest.py imports it) through its
encoders, the a6 round trip and the device inverse, and its kernel build
fails loudly."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import archon_tpu_torch
from archon_tpu_torch import cli, encode, decode, encode_file, decode_file
from archon_tpu_torch.ops import sort, _build
data = b"the port imports no jax " * 50
for pack in (False, True):
    assert decode_file(encode_file(data, "a7", 256, pack=pack, device="cpu")) == data
assert decode(encode(data, "a4", device="cpu"), "a4") == data
from archon_tpu_torch import a6_encode, a6_decode, ArchonConfig
assert ArchonConfig().coder == "byte"
for config in ("byte", "var"):
    assert a6_decode(a6_encode(data, config, device="cpu"), config, device="cpu") == data
assert decode(encode(data, "a7", device="cpu"), "a7", device="cpu") == data
assert sorted(archon_tpu_torch.__all__) == sorted(
    ["ArchonConfig", "a6_decode", "a6_encode", "decode", "decode_file", "encode", "encode_file"]
)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
print("ok")
"""


def test_import_and_cpu_encode_leave_jax_unloaded():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("nvcc", ["missing", "failing"])
def test_failed_kernel_build_raises(monkeypatch, tmp_path, nvcc):
    """No fallback when the CUDA kernels cannot be built: the build raises."""
    from archon_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    if nvcc == "missing":
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        match = "nvcc not found"
    else:
        monkeypatch.setattr(_build, "_nvcc", lambda: "false")
        match = "nvcc failed"
    with pytest.raises(RuntimeError, match=match):
        _build.load_library()
    assert _build._LIB is None and not list(tmp_path.glob("*.so"))


def test_port_sources_do_not_import_jax():
    for path in (ROOT / "archon_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and words[1].split(".")[0] == "jax"), (
                f"{path}: {line}"
            )
