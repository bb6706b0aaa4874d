"""The port imports no JAX and nothing of the JAX package (checked in a
fresh interpreter: this test process already holds both, tests/conftest.py
imports jax) through its encoders with every ``impl``, a resume, the a6 round
trip and the device inverse, and its kernel build fails loudly."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import os, sys, tempfile
import archon_tpu_torch
from archon_tpu_torch import cli, encode, decode, encode_file, decode_file, encode_to_path
from archon_tpu_torch.ops import sort, _build
data = b"the port imports no jax " * 50
for pack in (False, True):
    for impl in ("micro", "v3", "stream"):
        blob = encode_file(data, "a7", 256, impl=impl, pack=pack, device="cpu")
        assert decode_file(blob) == data
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "o.at")
        with open(out, "wb") as f:
            f.write(blob[: len(blob) // 2])
        assert 0 < encode_to_path(data, out, "a7", 256, resume=True, pack=pack, device="cpu") < 5
        with open(out, "rb") as f:
            assert f.read() == blob
assert decode(encode(data, "a4", device="cpu"), "a4") == data
from archon_tpu_torch import a6_encode, a6_decode, ArchonConfig
assert ArchonConfig().coder == "byte"
for config in ("byte", "var"):
    assert a6_decode(a6_encode(data, config, device="cpu"), config, device="cpu") == data
assert decode(encode(data, "a7", device="cpu"), "a7", device="cpu") == data
assert sorted(archon_tpu_torch.__all__) == sorted(
    ["ArchonConfig", "a6_decode", "a6_encode", "decode", "decode_file", "encode", "encode_file",
     "encode_to_path"]
)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "archon_tpu"))
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
    """Nor anything of the JAX package: no import whose first name is
    ``jax`` or ``archon_tpu``, in the port or in ``chip_smoke.py``."""
    sources = [*(ROOT / "archon_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    assert len(sources) > 20 and not (ROOT / "archon_tpu_torch" / "host.py").exists()
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] == ["from"]:
                names = words[1:2]
            elif words[:1] == ["import"]:
                names = [w for w in words[1:] if w != "as"]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib", "archon_tpu"}, (
                f"{path}: {line}"
            )
