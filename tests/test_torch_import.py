"""The port imports no JAX and nothing of the JAX package (checked in a
fresh interpreter: this test process already holds both, tests/conftest.py
imports jax) through its encoders with every ``impl``, a resume, the a6 round
trip, the device inverse, the v1, SA-IS and IT-2 sorters, the command line
with a profile, the mesh, the sharded megablock and its container, and every
module of the package (none needs ``triton`` to import); and its kernel build
fails loudly."""

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
    for impl in ("micro", "v3", "stream", "it2"):
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
    ["ArchonConfig", "__version__", "a6_decode", "a6_encode", "decode", "decode_file", "encode",
     "encode_file", "encode_to_path"]
)
import importlib, pkgutil
import numpy as np, torch
names = [m.name for m in pkgutil.walk_packages(archon_tpu_torch.__path__, "archon_tpu_torch.")]
for name in names:
    if not name.endswith("__main__"):  # importing it runs the command line
        importlib.import_module(name)
for new in ("core.fast", "core.it2", "core.sais_tpu", "ops.itn", "ops.sais", "entropy.coder",
            "golden.a6", "utils.corpus", "utils.timing", "utils.debug", "utils.tools",
            "parallel.collectives", "parallel.megablock", "parallel.megapipe", "parallel.dryrun"):
    assert "archon_tpu_torch." + new in names, new
from archon_tpu_torch.parallel import megapipe
from archon_tpu_torch.parallel.blocks import make_mesh
from archon_tpu_torch.parallel.dryrun import dryrun_multichip
assert encode_file(data, "a4", 256, dp=2, device="cpu") == encode_file(data, "a4", 256, device="cpu")
mega = megapipe.encode_megablock(data, make_mesh({"sp": 4}, devices=["cpu"] * 4), "a7")
assert mega[:4] == b"ATM1" and megapipe.decode_megablock(mega) == data
dryrun_multichip(2, device="cpu")
from archon_tpu_torch.core import bwt, fast, fast2, sais_tpu
from archon_tpu_torch.golden import a6 as golden_a6
arr = np.frombuffer(data, np.uint8)
t = torch.from_numpy(arr.copy())
sa = fast.suffix_array_fast(arr, "large", device="cpu")
assert bool(bwt.verify_sa(t, torch.from_numpy(sa), "large"))
L, base = sais_tpu.bwt_sais(t, "large")
Lw, bw = fast2.bwt_v3(t, "large")
assert torch.equal(L, Lw) and base == bw
assert golden_a6.a6_encode(data, "var") == a6_encode(data, "var", device="cpu")
with tempfile.TemporaryDirectory() as td:
    src, out, back, prof = (os.path.join(td, x) for x in ("in", "out", "back", "prof"))
    with open(src, "wb") as f:
        f.write(data)
    assert cli.main(["--profile-dir", prof, "e", src, out, "-b", "256", "--impl", "it2",
                     "--device", "cpu"]) == 0
    assert os.listdir(prof) and cli.main(["d", out, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data
    assert cli.main(["e", src, out, "--sp", "2", "--device", "cpu"]) == 0
    assert cli.main(["d", out, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "archon_tpu", "triton"))
assert not bad, bad
print("probe ok")
"""


def test_import_and_cpu_encode_leave_jax_unloaded():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "probe ok"


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
    assert len(sources) > 39 and {"it2.py", "sais_tpu.py", "fast.py", "tools.py", "timing.py",
                                  "debug.py", "megablock.py", "megapipe.py", "collectives.py",
                                  "dryrun.py"} <= {p.name for p in sources} and not (ROOT / "archon_tpu_torch" / "host.py").exists()
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
