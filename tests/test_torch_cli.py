"""The port's command line against the JAX package's: ``--impl it2``, the
stage report and ``--profile-dir``, ``a4|a7 d`` on the host or on a device,
and the options that wait for the multi-device slice."""

import pytest

from archon_tpu import cli as jcli
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import cli
from archon_tpu_torch.io import blocks

TEXT = text_like(20000, seed=31)
CPU = ("--device", "cpu")


def _report_shape(out):
    """The report's line heads, numbers cut off."""
    return [ln.split(":")[0] for ln in out.strip().splitlines()]


def test_cli_it2_writes_the_jax_container_and_report(tmp_path, capsys):
    src, out, ref = tmp_path / "in", tmp_path / "out", tmp_path / "ref"
    src.write_bytes(TEXT)
    assert cli.main(["e", str(src), str(out), "-b", "4096", "--impl", "it2", *CPU]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["e", str(src), str(ref), "-b", "4096", "--impl", "it2"]) == 0
    want = capsys.readouterr().out
    assert out.read_bytes() == ref.read_bytes()
    assert _report_shape(got) == _report_shape(want) == [
        f"{len(TEXT)} -> {out.stat().st_size} bytes", "Read time", "Transform time", "Write time",
        "Total time", "Linear coef"]
    back = tmp_path / "back"
    assert cli.main(["d", str(out), str(back)]) == 0
    assert back.read_bytes() == TEXT


@pytest.mark.parametrize("how", ["flag", "env"])
def test_cli_profile_dir_writes_a_trace(how, tmp_path, monkeypatch):
    src, out, prof = tmp_path / "in", tmp_path / "out", tmp_path / "prof"
    src.write_bytes(TEXT[:3000])
    args = ["e", str(src), str(out), "-b", "1024", "--impl", "stream", *CPU]
    if how == "flag":
        args = ["--profile-dir", str(prof), *args]
    else:
        monkeypatch.setenv("ARCHON_PROFILE_DIR", str(prof))
    assert cli.main(args) == 0
    (trace,) = prof.iterdir()
    assert trace.stat().st_size > 0
    assert blocks.decode_file(out.read_bytes()) == TEXT[:3000]


@pytest.mark.parametrize("gen", ["a4", "a7"])
def test_cli_single_block_decodes_on_host_or_device(gen, tmp_path, monkeypatch):
    src, blob = tmp_path / "in", tmp_path / "blob"
    src.write_bytes(TEXT[:5000])
    assert cli.main([gen, "e", str(src), str(blob), *CPU]) == 0
    from archon_tpu_torch import formats

    seen = []
    real = formats.decode
    monkeypatch.setattr(formats, "decode",
                        lambda d, g, device=None: seen.append(device) or real(d, g, device))
    for extra in ((), CPU):
        back = tmp_path / f"back{len(extra)}"
        assert cli.main([gen, "d", str(blob), str(back), *extra]) == 0
        assert back.read_bytes() == TEXT[:5000]
    assert seen == [None, "cpu"]  # the host walk unless a device is asked for


def test_cli_config_carries_the_jax_fields(monkeypatch):
    args = cli._parser().parse_args(["--profile-dir", "p", "e", "a", "b", "--dp", "1", "--sp", "1",
                                     "--impl", "it2"])
    cfg = cli._config_from_args(args)
    assert (cfg.dp, cfg.sp, cfg.profile_dir, cfg.impl) == (1, 1, "p", "it2")
    monkeypatch.setenv("ARCHON_PROFILE_DIR", "q")
    cfg = cli._config_from_args(cli._parser().parse_args(["a4", "d", "a", "b"]))
    assert cfg.profile_dir == "q" and cfg.use_native
    assert not cli._config_from_args(cli._parser().parse_args(["a4", "d", "a", "b", *CPU])).use_native


@pytest.mark.parametrize("extra", [("--dp", "2"), ("--sp", "2"), ("--dp", "2", "--resume")])
def test_cli_multi_device_options_raise(extra, tmp_path):
    src = tmp_path / "in"
    src.write_bytes(TEXT[:2000])
    with pytest.raises(ValueError, match="multi-device slice"):
        cli.main(["e", str(src), str(tmp_path / "out"), *CPU, *extra])


def test_megablock_container_is_named(tmp_path):
    blob = b"ATM1" + bytes(40)
    for fn in (blocks.decode_file, lambda b: blocks.extract_block(b, 0)):
        with pytest.raises(ValueError, match="ATM1.*multi-device slice"):
            fn(blob)
    src = tmp_path / "in"
    src.write_bytes(blob)
    with pytest.raises(ValueError, match="multi-device slice"):
        cli.main(["d", str(src), str(tmp_path / "out")])
    with pytest.raises(ValueError, match="bad magic"):
        blocks.decode_file(b"NOPE" + bytes(40))
