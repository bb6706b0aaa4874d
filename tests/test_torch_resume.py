"""The port's container entry points with every ``impl``, resume and block
extraction, against the JAX package on the same seeded inputs: the same
bytes, the same return values (tolerance 0).  Every port call runs on the
CPU (``device="cpu"``: the sorts take their plain twins).
"""

import numpy as np
import pytest
import torch

import archon_tpu
from archon_tpu import cli as jcli
from archon_tpu.io import blocks as jblocks
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import cli, encode_to_path, formats
from archon_tpu_torch.io import blocks

BLOCK = 4096
TEXT = text_like(3 * BLOCK + 1000, 5)  # three whole blocks and a short last one
IMPLS = ["micro", "v3", "stream", "it2"]


def _planted_repeat(n, rep_len, alpha, seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, alpha, n, dtype=np.uint8)
    blk = rng.integers(0, alpha, rep_len, dtype=np.uint8)
    row[500 : 500 + rep_len] = blk
    row[n // 2 : n // 2 + rep_len] = blk
    return row.tobytes()


@pytest.mark.parametrize("pack", [False, True], ids=["ATA1", "ATA2"])
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_file_matches_jax(impl, pack):
    for gen, data in (("a4", TEXT), ("a7", TEXT[: 2 * BLOCK]), ("a4", b""), ("a7", b"x")):
        want = archon_tpu.encode_file(data, gen, BLOCK, impl=impl, pack=pack)
        got = blocks.encode_file(data, gen, BLOCK, impl=impl, pack=pack, device="cpu")
        assert got == want, (gen, len(data))
        assert blocks.decode_file(got) == data


def test_impls_write_one_anothers_bytes_and_default_is_micro():
    outs = {impl: blocks.encode_file(TEXT, "a7", BLOCK, impl=impl, device="cpu") for impl in IMPLS}
    assert outs["micro"] == outs["v3"] == outs["stream"]
    assert blocks.encode_file(TEXT, "a7", BLOCK, device="cpu") == outs["micro"]
    for verify in (False, True):
        assert blocks.encode_file(TEXT, "a7", BLOCK, verify, "micro", device="cpu") == outs["v3"]


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_fallback_row_matches_jax(generation, monkeypatch):
    """A block the micro program cannot resolve (ties 1000 bytes deep, past
    its context) beside two it can: the row goes through ``_fallback_row``
    and the container is the JAX package's and the stream's."""
    n = 32768
    data = text_like(n, 3) + _planted_repeat(n, 1000, 256, 9) + text_like(n, 4)
    monkeypatch.setattr(blocks._fallback_row, "calls", 0)
    got = blocks.encode_file(data, generation, n, device="cpu")
    assert blocks._fallback_row.calls == 1
    assert got == archon_tpu.encode_file(data, generation, n)
    assert got == blocks.encode_file(data, generation, n, impl="stream", device="cpu")
    assert blocks.encode_file(data, generation, n, verify=False, device="cpu") == got
    assert blocks._fallback_row.calls == 2
    assert blocks.decode_file(got) == data


def test_fallback_row_past_the_micro_capacity():
    """A block that leaves the full rounds with more than 4096 actives (the
    other way a row stays unresolved): exact through the fallback."""
    n = 1 << 17
    data = _planted_repeat(n, 3000, 256, 11)
    calls = blocks._fallback_row.calls
    got = blocks.encode_file(data, "a4", n, device="cpu")
    assert blocks._fallback_row.calls == calls + 1
    assert got == blocks.encode_file(data, "a4", n, impl="stream", device="cpu")
    assert got == blocks.encode_file(data, "a4", n, impl="v3", device="cpu")
    assert got[12 + 4 :] == formats.encode(data, "a4", device="cpu")


@pytest.mark.parametrize("pipe", ["0", "1", "3"])
def test_pipe_blocks_env_is_honoured(pipe, monkeypatch):
    """ARCHON_PIPE_BLOCKS sizes the batched units and the stream's window (0:
    all blocks); the bytes do not depend on it."""
    data = TEXT + text_like(2 * BLOCK, 8)
    want = archon_tpu.encode_file(data, "a4", BLOCK)
    seen = []
    import archon_tpu_torch.parallel.blocks as pblocks

    real = pblocks.bwt_blocks_micro_certified
    monkeypatch.setattr(pblocks, "bwt_blocks_micro_certified",
                        lambda d, s, mesh=None: seen.append(d.shape[0]) or real(d, s, mesh=mesh))
    monkeypatch.setenv("ARCHON_PIPE_BLOCKS", pipe)
    assert blocks.encode_file(data, "a4", BLOCK, device="cpu") == want
    # 5 whole blocks, then a short one of its own
    assert seen == {"0": [5, 1], "1": [1] * 6, "3": [3, 2, 1]}[pipe]
    assert blocks.encode_file(data, "a4", BLOCK, impl="stream", device="cpu") == want


def test_bad_arguments_raise(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="unknown impl"):
        blocks.encode_file(TEXT, "a4", BLOCK, impl="nope", device="cpu")
    # dp=2 raised until the mesh was ported: now it writes the bytes of dp=1
    assert blocks.encode_file(TEXT, "a4", BLOCK, dp=2, device="cpu") == blocks.encode_file(
        TEXT, "a4", BLOCK, device="cpu")
    with pytest.raises(ValueError, match="generation"):
        blocks.encode_to_path(TEXT, "/dev/null", "a5", device="cpu")
    # no quiet step back to the CPU: a CUDA request without a usable card raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for impl in IMPLS:
        with pytest.raises(RuntimeError):
            blocks.encode_file(TEXT, "a4", BLOCK, impl=impl)
        with pytest.raises(RuntimeError):
            encode_to_path(TEXT, tmp_path / "o", "a4", BLOCK, impl=impl)


def _both(tmp_path, name, seed_bytes, data, **kw):
    """Run ``encode_to_path(resume=True)`` of both packages on files that
    start with ``seed_bytes``; returns (port's count, JAX's count, port's
    file, JAX's file)."""
    tp, jp = tmp_path / f"{name}.t", tmp_path / f"{name}.j"
    if seed_bytes is not None:
        tp.write_bytes(seed_bytes)
        jp.write_bytes(seed_bytes)
    got = encode_to_path(data, tp, block_size=1024, resume=True, device="cpu", **kw)
    want = jblocks.encode_to_path(data, jp, block_size=1024, resume=True, **kw)
    return got, want, tp.read_bytes(), jp.read_bytes()


RESUME_DATA = text_like(10 * 1024 + 300, seed=3)


@pytest.mark.parametrize("pack", [False, True], ids=["ATA1", "ATA2"])
@pytest.mark.parametrize("case", ["no_file", "in_a_frame", "in_a_frame_header", "in_the_header",
                                  "complete", "drift_same_length", "shrunk_input",
                                  "changed_kind", "changed_block_size"])
def test_encode_to_path_resume_matches_jax(case, pack, tmp_path):
    data = RESUME_DATA
    full = blocks.encode_file(data, "a4", 1024, pack=pack, device="cpu")
    assert full == archon_tpu.encode_file(data, "a4", 1024, pack=pack)
    # frame starts of the full container
    starts, pos = [], 12
    while pos < len(full):
        starts.append(pos)
        n = int.from_bytes(full[pos : pos + 4], "little")
        pos += (12 + int.from_bytes(full[pos + 4 : pos + 8], "little")) if pack else 8 + n
    total = len(starts)
    assert total == 11
    new_data, seed, redo = data, full, 0
    if case == "no_file":
        seed, redo = None, total
    elif case == "in_a_frame":
        seed, redo = full[: starts[4] + (starts[5] - starts[4]) // 3], total - 4
    elif case == "in_a_frame_header":
        seed, redo = full[: starts[6] + 2], total - 6
    elif case == "in_the_header":
        seed, redo = full[:7], total
    elif case == "drift_same_length":
        # one byte changed inside the last kept block: every frame is stale
        seed = full[: starts[5]]
        new_data = data[: 4 * 1024 + 77] + bytes([data[4 * 1024 + 77] ^ 1]) + data[4 * 1024 + 78 :]
        redo = total
    elif case == "shrunk_input":
        # the scan stops at the first frame whose length disagrees
        new_data, redo = data[: 3 * 1024 + 500], 1
    elif case == "changed_kind":
        seed, redo = blocks.encode_file(data, "a4", 1024, pack=not pack, device="cpu"), total
    elif case == "changed_block_size":
        seed, redo = blocks.encode_file(data, "a4", 2048, pack=pack, device="cpu"), total
    got, want, tbytes, jbytes = _both(tmp_path, case, seed, new_data, pack=pack)
    assert got == want == redo
    assert tbytes == jbytes == blocks.encode_file(new_data, "a4", 1024, pack=pack, device="cpu")
    assert blocks.decode_file(tbytes) == new_data


def test_encode_to_path_without_resume_overwrites_and_flushes(tmp_path):
    out = tmp_path / "o.at"
    out.write_bytes(b"stale bytes that are no container")
    for impl in IMPLS:
        n = encode_to_path(TEXT, out, "a7", BLOCK, flush_blocks=3, impl=impl, pack=True,
                           device="cpu")
        assert n == 4
        assert out.read_bytes() == archon_tpu.encode_file(TEXT, "a7", BLOCK, pack=True)


def test_last_frame_matches_answers_without_the_library(tmp_path, monkeypatch):
    """The drift guard decodes through ``native.unbwt`` on both branches;
    the port's answers with the golden walk when the library is missing."""
    from archon_tpu_torch import native

    data = text_like(3 * 1024, 6)
    for pack in (False, True):
        out = tmp_path / f"o{pack}.at"
        encode_to_path(data, out, block_size=1024, pack=pack, device="cpu")
        count, end, last, packed = blocks._scan_complete_blocks(out, "a4", 1024, [1024] * 3)
        assert (count, packed, end) == (3, pack, len(out.read_bytes()))
        assert (count, end, last, packed) == jblocks._scan_complete_blocks(out, "a4", 1024, [1024] * 3)
        with monkeypatch.context() as m:
            m.setattr(native, "_TRIED", True)
            m.setattr(native, "_LIB", None)
            assert blocks._last_frame_matches(out, last, end, "a4", data[2048:], packed=pack)
            assert not blocks._last_frame_matches(out, last, end, "a4", data[1024:2048], packed=pack)
        assert blocks._last_frame_matches(out, last, end, "a4", data[2048:], packed=pack)
        assert not blocks._last_frame_matches(out, last, end, "a7", data[2048:], packed=pack)
    assert blocks._scan_complete_blocks(tmp_path / "missing", "a4", 1024) is None
    assert blocks._scan_complete_blocks(out, "a7", 1024) is None


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_extract_block_of_both_containers(generation):
    ata1 = blocks.encode_file(TEXT, generation, BLOCK, device="cpu")
    ata2 = blocks.encode_file(TEXT, generation, BLOCK, pack=True, device="cpu")
    for i in range(4):
        blk = TEXT[i * BLOCK : (i + 1) * BLOCK]
        one = blocks.extract_block(ata1, i)
        assert one == blocks.extract_block(ata2, i)
        assert one == jblocks.extract_block(ata1, i) == jblocks.extract_block(ata2, i)
        assert one == formats.encode(blk, generation, device="cpu")
        assert formats.decode(one, generation) == blk
    with pytest.raises(IndexError):
        blocks.extract_block(ata1, 4)
    with pytest.raises(ValueError):
        blocks.extract_block(b"NOPE" + ata1[4:], 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_cli_impl_flag(impl, tmp_path):
    src, out, ref = tmp_path / "in", tmp_path / "out", tmp_path / "ref"
    src.write_bytes(TEXT)
    assert cli.main(["e", str(src), str(out), "-b", str(BLOCK), "--impl", impl,
                     "--device", "cpu"]) == 0
    assert jcli.main(["e", str(src), str(ref), "-b", str(BLOCK), "--impl", impl]) == 0
    assert out.read_bytes() == ref.read_bytes()
    with pytest.raises(SystemExit):
        cli.main(["e", str(src), str(out), "--impl", "it3", "--device", "cpu"])


def test_cli_resume_flag(tmp_path, capsys):
    """``--resume`` goes through ``encode_to_path`` and prints the JAX CLI's
    report line: all blocks first, none on a second run, the tail after a
    cut in the middle of a frame."""
    src, out, ref = tmp_path / "in", tmp_path / "out", tmp_path / "ref"
    data = text_like(8 * 1024, 9)
    src.write_bytes(data)
    args = ["-b", "1024", "--resume"]

    def report(main, target, extra=()):
        assert main(["e", str(src), str(target), *args, *extra]) == 0
        return capsys.readouterr().out.strip().rsplit(",", 1)[0]

    cpu = ("--device", "cpu")
    assert report(cli.main, out, cpu) == report(jcli.main, ref)
    assert "(8 block(s) recomputed" in report(cli.main, tmp_path / "fresh", cpu)
    assert "(0 block(s) recomputed" in report(cli.main, out, cpu)
    whole = out.read_bytes()
    assert whole == ref.read_bytes()
    out.write_bytes(whole[: 12 + 5 * 1032 + 100])
    ref.write_bytes(whole[: 12 + 5 * 1032 + 100])
    assert report(cli.main, out, cpu) == report(jcli.main, ref)
    assert out.read_bytes() == whole == ref.read_bytes()
