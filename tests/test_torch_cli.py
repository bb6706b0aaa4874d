"""The port's command line against the JAX package's: ``--impl it2``, the
stage report and ``--profile-dir``, ``a4|a7 d`` on the host or on a device,
``--dp`` and ``--sp``, and ``d`` on an ``ATM1`` file."""

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
def test_cli_multi_device_options_raise(extra, tmp_path, capsys):
    """They raised until the mesh was ported; now each writes what the JAX
    command line writes with the same options, and ``d`` gives the input back."""
    src, out, ref, back = (tmp_path / x for x in ("in", "out", "ref", "back"))
    src.write_bytes(TEXT[:2000])
    assert cli.main(["e", str(src), str(out), "-b", "512", *CPU, *extra]) == 0
    printed = capsys.readouterr().out
    assert ("2 shards on 1 device (cpu)" in printed) == ("--sp" in extra)
    assert jcli.main(["e", str(src), str(ref), "-b", "512", *extra]) == 0
    assert out.read_bytes() == ref.read_bytes()
    assert out.read_bytes()[:4] == (b"ATM1" if "--sp" in extra else b"ATA1")
    assert cli.main(["d", str(out), str(back)]) == 0
    assert back.read_bytes() == TEXT[:2000]


def test_megablock_container_is_named(tmp_path):
    """``decode_file`` and ``extract_block`` answer an ``ATM1`` blob by name
    (the JAX ``decode_file`` answers "bad magic"); the command line's ``d``
    reads it."""
    from archon_tpu_torch.parallel import megapipe
    from archon_tpu_torch.parallel.blocks import make_mesh

    blob = megapipe.encode_megablock(TEXT[:2000], make_mesh({"sp": 2}, devices=["cpu"] * 2))
    assert blob[:4] == b"ATM1"
    for fn in (blocks.decode_file, lambda b: blocks.extract_block(b, 0)):
        with pytest.raises(ValueError, match="bad magic.*ATM1.*megapipe"):
            fn(blob)
    src, back = tmp_path / "in", tmp_path / "back"
    src.write_bytes(blob)
    assert cli.main(["d", str(src), str(back)]) == 0
    assert back.read_bytes() == TEXT[:2000]
    with pytest.raises(ValueError, match="bad magic"):
        blocks.decode_file(b"NOPE" + bytes(40))


def test_sp_with_a_card_for_every_shard_spawns_one_rank_a_card(tmp_path, monkeypatch, capsys):
    """Which layout ``e --sp N --device cuda`` takes is decided by the card
    count alone: N or more cards, one process a card over NCCL."""
    import torch

    from archon_tpu_torch.parallel import collectives

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(collectives, "spawn", lambda fn, world, backend, *a: calls.append(
        (fn.__name__, world, backend, a[1:])) or b"blob")
    src, out = tmp_path / "in", tmp_path / "out"
    src.write_bytes(TEXT[:2000])
    assert cli.main(["e", str(src), str(out), "--sp", "2", "-g", "a7"]) == 0
    assert calls == [("_encode_on_rank", 2, "nccl", ("cuda", "a7", "var"))]
    assert out.read_bytes() == b"blob" and "2 shards on 2 devices" in capsys.readouterr().out
