"""The ``ATM1`` container across the two packages: what
``archon_tpu.parallel.megapipe`` writes on the 8-device CPU mesh the port
reads, what the port writes (8 shards in process on the CPU) is the same
bytes, and each side decodes the other's; bytes compared exactly."""

import jax
import pytest

from archon_tpu import cli as jcli
from archon_tpu.parallel import megapipe as jmp
from archon_tpu.parallel.blocks import make_mesh as jax_mesh
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import cli, native
from archon_tpu_torch.parallel import megapipe as mp
from archon_tpu_torch.parallel.blocks import make_mesh
from archon_tpu_torch.parallel.collectives import spawn

TEXT = text_like(8192, seed=9)
INPUTS = {"text": TEXT, "pad": TEXT[:-3], "zeros": bytes(2048)}


def _jax_mesh(ns):
    return jax_mesh({"sp": ns}, devices=jax.devices()[:ns])


def _mesh(ns):
    return make_mesh({"sp": ns}, devices=["cpu"] * ns)


@pytest.fixture(scope="module")
def jax_blobs():
    """Every blob of the JAX package the tests read, made once: few distinct
    (ns, n, sentinel) shapes, since each is a fresh XLA compile."""
    blobs = {}
    for ns in (2, 8):
        for name, data in INPUTS.items():
            for gen in ("a4", "a7"):
                for coder in ("byte", "var"):
                    if name == "zeros" and (gen, coder, ns) != ("a4", "var", 8):
                        continue
                    blobs[ns, name, gen, coder] = jmp.encode_megablock(
                        data, _jax_mesh(ns), gen, coder)
    return blobs


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "no_native"])
def test_port_decodes_the_jax_blobs(jax_blobs, use_native, monkeypatch):
    """Both coders, both generations, pad > 0 and the single-symbol alphabet,
    with the native library and without it (the python bit walk and the
    port's ``bwt_inverse`` on CPU tensors)."""
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    elif not native.available():
        pytest.skip("no C++ toolchain: the native library did not build")
    for (ns, name, _gen, _coder), blob in jax_blobs.items():
        if ns == 8:
            assert mp.decode_megablock(blob) == INPUTS[name], (name, _gen, _coder)
    with pytest.raises(ValueError, match="bad magic"):
        mp.decode_megablock(b"ATA1" + bytes(40))


@pytest.mark.parametrize("ns", [2, 8])
@pytest.mark.parametrize("coder", ["byte", "var"])
@pytest.mark.parametrize("gen", ["a4", "a7"])
def test_port_writes_the_jax_bytes(jax_blobs, gen, coder, ns):
    for name in ("text", "pad"):
        want = jax_blobs[ns, name, gen, coder]
        got = mp.encode_megablock(INPUTS[name], _mesh(ns), gen, coder)
        assert got == want, name
        assert jmp.decode_megablock(got) == INPUTS[name]
    if coder == "var":
        assert len(got) < len(INPUTS["pad"])  # the entropy stage compresses text


def test_degenerate_alphabet_round_trips_both_ways(jax_blobs):
    want = jax_blobs[8, "zeros", "a4", "var"]
    got = mp.encode_megablock(INPUTS["zeros"], _mesh(8), "a4", "var")
    assert got == want
    assert mp.decode_megablock(got) == jmp.decode_megablock(got) == INPUTS["zeros"]


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="unknown generation"):
        mp.encode_megablock(TEXT, _mesh(2), "a5")
    with pytest.raises(ValueError, match="unknown coder"):
        mp.encode_megablock(TEXT, _mesh(2), "a4", "fix")


def test_gloo_ranks_write_the_in_process_blob(jax_blobs):
    """Two spawned ranks, one shard each (the pad, the histogram's psum and
    the frames' all_gather over gloo): the bytes of the in-process form."""
    got = spawn(mp._encode_on_rank, 2, "gloo", INPUTS["pad"], "cpu", "a7", "var")
    assert got == jax_blobs[2, "pad", "a7", "var"]


def test_cli_sp_writes_the_jax_blob_and_d_reads_it(jax_blobs, tmp_path, capsys):
    src, out, ref, back = (tmp_path / x for x in ("in", "out", "ref", "back"))
    src.write_bytes(INPUTS["pad"])
    assert cli.main(["e", str(src), str(out), "--sp", "8", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "8 shards on 1 device (cpu)" in printed and "Linear coef" in printed
    assert out.read_bytes() == jax_blobs[8, "pad", "a4", "var"]
    assert jcli.main(["e", str(src), str(ref), "--sp", "8"]) == 0
    assert ref.read_bytes() == out.read_bytes()
    assert cli.main(["d", str(out), str(back)]) == 0
    assert back.read_bytes() == INPUTS["pad"]
    assert cli.main(["e", str(src), str(out), "--sp", "2", "-g", "a7", "--device", "cpu"]) == 0
    assert out.read_bytes() == jax_blobs[2, "pad", "a7", "var"]
    assert jcli.main(["d", str(out), str(back)]) == 0
    assert back.read_bytes() == INPUTS["pad"]
