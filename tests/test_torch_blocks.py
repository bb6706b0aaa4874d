"""Port's containers, single-block formats and CLI vs the JAX package.

Every encode runs on the CPU (``device="cpu"``: the sort wrappers take their
plain twins) and must give the JAX package's bytes exactly.
"""

import numpy as np
import pytest
import torch

import archon_tpu
from archon_tpu import formats as jformats
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import cli, formats
from archon_tpu_torch.io import blocks

BLOCK = 8192
INPUTS = {
    "empty": (b"", BLOCK),
    "one_byte": (b"x", BLOCK),
    "three_blocks_ragged_tail": (text_like(3 * BLOCK + 1000, 5), BLOCK),
}


@pytest.mark.parametrize("generation", ["a4", "a7"])
@pytest.mark.parametrize("pack", [False, True], ids=["ATA1", "ATA2"])
def test_encode_file_matches_jax_stream(generation, pack):
    for name, (data, bs) in INPUTS.items():
        want = archon_tpu.encode_file(data, generation, bs, impl="stream", pack=pack)
        got = blocks.encode_file(data, generation, bs, pack=pack, device="cpu")
        assert got == want, name
        assert blocks.decode_file(got) == data, name
        assert archon_tpu.decode_file(got) == data, name


def test_decode_file_isolates_a_corrupt_block():
    data = text_like(4096)
    blob = bytearray(blocks.encode_file(data, "a4", 1024, device="cpu"))
    base_off = 12 + (4 + 1024 + 4) + 4 + 1024  # block 1's base field
    blob[base_off : base_off + 4] = (10**9).to_bytes(4, "little")
    errors = []
    out = blocks.decode_file(bytes(blob), strict=False, on_error=lambda i, e: errors.append(i))
    assert errors == [1]
    assert out == data[:1024] + b"\x00" * 1024 + data[2048:]
    with pytest.raises(ValueError):
        blocks.decode_file(bytes(blob), strict=True)
    with pytest.raises(ValueError):
        blocks.decode_file(b"NOPE" + bytes(8))


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_formats_match_jax(generation):
    for data in (b"", b"banana", text_like(3000, 3)):
        got = formats.encode(data, generation, device="cpu")
        assert got == jformats.encode(data, generation)
        assert formats.decode(got, generation) == data


def test_cli_roundtrip(tmp_path):
    data = text_like(10_000, 4)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    enc, dec = tmp_path / "out.ata", tmp_path / "back.bin"
    assert cli.main(["e", str(src), str(enc), "-g", "a7", "-b", "4096", "--pack",
                     "--device", "cpu"]) == 0
    assert enc.read_bytes() == blocks.encode_file(data, "a7", 4096, pack=True, device="cpu")
    assert cli.main(["d", str(enc), str(dec)]) == 0
    assert dec.read_bytes() == data
    one, back = tmp_path / "one.a4", tmp_path / "one.bin"
    assert cli.main(["a4", "e", str(src), str(one), "--device", "cpu"]) == 0
    assert one.read_bytes() == formats.encode(data, "a4", device="cpu")
    assert cli.main(["a4", "d", str(one), str(back)]) == 0
    assert back.read_bytes() == data


def test_cuda_device_without_a_card_raises(monkeypatch):
    """No silent fallback to the CPU: a CUDA request with no usable card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        blocks.encode_file(b"banana", "a4", device="cuda")
    with pytest.raises(RuntimeError):
        formats.encode(b"banana", "a4")
    with pytest.raises(RuntimeError):
        cli.main(["a7", "e", __file__, "/dev/null"])


def test_host_walk_names_the_walk_verify_uses(monkeypatch):
    from archon_tpu import native

    assert blocks.host_walk() == ("native" if native.available() else "golden")
    monkeypatch.setattr(native, "available", lambda: False)
    assert blocks.host_walk() == "golden"
    # the golden walk is exact too, only slower
    data = text_like(2000, 6)
    assert blocks.decode_file(blocks.encode_file(data, "a7", 512, device="cpu")) == data
