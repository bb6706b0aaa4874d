"""CUDA kernels, the forward BWT, a6 and the device inverse on the card
(marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card.  The file
imports no JAX, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from archon_tpu.golden import a6 as golden_a6
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import formats
from archon_tpu_torch.core import a6, fast2, unbwt
from archon_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _hold_kernels_to_twins(keys, payloads):
    """K1 and every K2 level against their twins on the tuples (every row),
    then the whole sort against its twin; both kernels must launch."""
    mat = torch.stack(keys)
    before = (tsort.sort_tiles.launches, tsort.merge_level.launches)
    tuples = tsort.sort_tiles(mat)
    assert torch.equal(tuples, tsort.sort_tiles_ref(mat))
    run = tsort.TILE
    while run < tuples.shape[1]:
        nxt = tsort.merge_level(mat, tuples, run)
        assert torch.equal(nxt, tsort.merge_level_ref(mat, tuples, run))
        tuples, run = nxt, 2 * run
    got = tsort.sort_operands(keys, payloads)
    want = tsort.sort_operands_ref(keys, payloads)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tsort.sort_tiles.launches > before[0]
    if tuples.shape[1] > tsort.TILE:
        assert tsort.merge_level.launches > before[1]


@pytest.mark.parametrize("n,nk,hi", [(1, 3, 5), (4096, 49, 3), (20_011, 49, 3),
                                     (100_003, 4, 1000), ((1 << 22) - 17, 4, 1 << 16)])
def test_kernels_match_twins_on_card(cuda_device, n, nk, hi):
    rng = np.random.default_rng(n)
    keys = [torch.from_numpy(rng.integers(-1, hi, n).astype(np.int32)).to(cuda_device)
            for _ in range(nk)]
    _hold_kernels_to_twins(keys, [keys[0]])


def test_kernels_match_twins_on_text_trigram_keys(cuda_device):
    """The forward BWT's bootstrap sort of a 4 MiB text block: four packed
    trigram keys + index at 2^22, ties past key 0 on every repeated word."""
    data = torch.from_numpy(np.frombuffer(text_like(1 << 22, 9), np.uint8).copy()).to(cuda_device)
    n = data.shape[0]
    p27 = fast2._trigram_keys(data, "small")
    keys = [p27[3 * j:3 * j + n].contiguous() for j in range(4)]
    _hold_kernels_to_twins(keys, [torch.arange(n, dtype=torch.int32, device=cuda_device),
                                  torch.roll(data, 1)])


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_bwt_v3_on_card_matches_golden(cuda_device, sentinel):
    rng = np.random.default_rng(5)
    rep = rng.integers(0, 2, 1000, dtype=np.uint8)
    planted = rng.integers(0, 2, 32768, dtype=np.uint8)
    planted[1000:2000] = rep
    planted[16384:17384] = rep
    for arr in (np.frombuffer(b"mississippi" * 300, np.uint8), planted):
        L, base = fast2.bwt_v3(torch.from_numpy(arr.copy()).to(cuda_device), sentinel)
        want_L, want_base = golden.bwt_forward(arr, sentinel)
        assert np.array_equal(L.cpu().numpy(), want_L) and base == want_base


@pytest.mark.parametrize("config", ["byte", "fix", "var"])
def test_a6_on_card_matches_golden(cuda_device, config):
    rng = np.random.default_rng(6)
    for data in (b"abracadabra alakazam", text_like(5000, 3),
                 bytes(rng.integers(0, 50, 20_000, dtype=np.uint8))):
        blob = a6.a6_encode(data, config, device=cuda_device)
        assert blob == golden_a6.a6_encode(data, config)
        assert a6.a6_decode(blob, config, device=cuda_device) == data
        arr = np.frombuffer(data, np.uint8)
        if config != "byte":
            bits = a6.a6_forward(arr, config, impl="bits", device=cuda_device)
            assert bits[1] == int.from_bytes(blob[:4], "little")
            assert bits[0].tobytes() == blob[4:]


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("n", [1, 5000, 20011])
def test_device_inverse_on_card_matches_host_walk(cuda_device, sentinel, n):
    arr = np.frombuffer(text_like(n, 4), np.uint8)
    L, base = golden.bwt_forward(arr, sentinel)
    got = unbwt.bwt_inverse(torch.from_numpy(L.copy()).to(cuda_device), int(base), sentinel)
    assert got.device.type == "cuda"
    assert np.array_equal(got.cpu().numpy(), golden.bwt_inverse(L, base, sentinel))
    gen = "a4" if sentinel == "small" else "a7"
    blob = formats.encode(arr.tobytes(), gen, device=cuda_device)
    assert formats.decode(blob, gen, device=cuda_device) == formats.decode(blob, gen) == arr.tobytes()


@pytest.mark.parametrize("B,n,nk,hi", [(1, 1000, 2, 5), (3, 20_011, 2, 7), (8, 4096, 13, 2),
                                       (8, 4096, 49, 2), (4, 100_003, 4, 1000), (2, 8192, 1, 2)])
def test_sort_rows_on_card_matches_twin(cuda_device, B, n, nk, hi):
    """The batched sort through K1 and K2 (rows end to end, levels stopping
    at the row) against stable ``torch.sort`` passes, with uint8, bool and
    index payloads; one K1 launch and one K2 launch per level for all rows."""
    rng = np.random.default_rng(B * n + nk)
    keys = [torch.from_numpy(rng.integers(-1, hi, (B, n)).astype(np.int32)).to(cuda_device)
            for _ in range(nk)]
    keys[0][:, ::11] = 0x7FFFFFFF  # a real key equal to the padding key
    payloads = [torch.from_numpy(rng.integers(0, 256, (B, n), dtype=np.uint8)).to(cuda_device),
                keys[-1] > 0,
                torch.arange(n, dtype=torch.int32, device=cuda_device).expand(B, n)]
    before = (tsort.sort_tiles.launches, tsort.merge_level.launches)
    got = tsort.sort_rows(keys, payloads)
    levels = (tsort.row_width(B, n) // tsort.TILE - 1).bit_length()
    assert tsort.sort_tiles.launches == before[0] + 1
    assert tsort.merge_level.launches == before[1] + levels
    want = tsort.sort_rows_ref(keys, payloads)
    assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_batched_containers_on_card_match_stream(cuda_device, generation):
    """micro (with a row through the fallback) and v3 write the stream's
    bytes on the card, certificate on and off, packed and not."""
    from archon_tpu_torch.io import blocks

    n = 1 << 17
    rng = np.random.default_rng(11)
    deep = rng.integers(0, 256, n, dtype=np.uint8)
    deep[500:3500] = deep[n // 2 : n // 2 + 3000]  # more than 4096 actives at the loop's exit
    data = text_like(2 * n, 3) + deep.tobytes() + text_like(n + 777, 4)
    want = blocks.encode_file(data, generation, n, impl="stream", device=cuda_device)
    assert blocks.decode_file(want) == data
    calls = blocks._fallback_row.calls
    for verify in (True, False):
        for impl in ("micro", "v3"):
            got = blocks.encode_file(data, generation, n, verify=verify, impl=impl,
                                     device=cuda_device)
            assert got == want, (impl, verify)
    assert blocks._fallback_row.calls == calls + 2
    packed = blocks.encode_file(data, generation, n, pack=True, device=cuda_device)
    assert blocks.decode_file(packed) == data
    assert blocks.extract_block(packed, 2) == blocks.extract_block(want, 2)


def test_certificate_on_card_rejects_corruption(cuda_device):
    from archon_tpu_torch.core import batched

    rows = np.stack([np.frombuffer(text_like(20_011, s), np.uint8) for s in range(4)])
    data2 = torch.from_numpy(rows).to(cuda_device)
    L, base, ok = batched.bwt_batched_v3_certified(data2, "large")
    assert ok.all()
    for b in range(4):
        want_L, want_base = golden.bwt_forward(rows[b], "large")
        assert np.array_equal(L[b].cpu().numpy(), want_L) and int(base[b]) == int(want_base)
    _, _, rank = batched._bwt_batched_v3_impl(data2, "large", want_rank=True)
    bad = L.clone()
    bad[2, 99] ^= 1
    assert batched.verify_bwt_batched(data2, rank, bad, base, "large").tolist() == [
        True, True, False, True]
    assert batched.verify_bwt_batched(data2, rank, L, base + 1, "large").tolist() == [False] * 4
