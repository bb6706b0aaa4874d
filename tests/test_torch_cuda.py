"""CUDA kernels, the forward BWT (v3, v1, IT-2, SA-IS), a6, the device
inverse and the sharded megablock on the card (marker ``cuda``).

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


def test_sort_byte_counters_count_real_elements(cuda_device):
    """``sort_tiles.bytes`` and ``merge_level.bytes`` grow by what each
    launch needs for the caller's B * n elements, never the padded width:
    4 (2C + 1) bytes an element for K1, 2 * 4 (C + 1) for each K2 level; one
    ``sort_rows`` call (rows padded from 20,000 to 32,768 columns) and one
    ``merge_rows`` call, at 2 and at 5 keys (C = 2 and 4)."""
    rng = np.random.default_rng(11)
    B, n = 3, 20_000
    w = 2 * tsort.MERGE_TILE
    for nk in (2, 5):
        C = tsort.carried(nk)
        keys = [torch.from_numpy(rng.integers(0, 50, (B, n)).astype(np.int32)).to(cuda_device)
                for _ in range(nk)]
        bytes1, bytes2 = tsort.sort_tiles.bytes, tsort.merge_level.bytes
        tsort.sort_rows(keys, [keys[0]])
        levels = (tsort.row_width(B, n) // tsort.TILE - 1).bit_length()
        assert tsort.sort_tiles.bytes - bytes1 == 4 * (2 * C + 1) * B * n
        assert tsort.merge_level.bytes - bytes2 == levels * 2 * 4 * (C + 1) * B * n
        runs = [torch.from_numpy(np.sort(rng.integers(0, 50, (B, 2, w // 2)), axis=2).reshape(B, w)
                                 .astype(np.int32)).to(cuda_device) for _ in range(nk)]
        bytes1, bytes2 = tsort.sort_tiles.bytes, tsort.merge_level.bytes
        tsort.merge_rows(runs, [])
        assert tsort.sort_tiles.bytes == bytes1
        assert tsort.merge_level.bytes - bytes2 == 2 * 4 * (C + 1) * B * w


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
    _, _, rank = batched._bwt_batched_v3_impl(data2, torch.roll(data2, 1, dims=1), "large",
                                              want_rank=True)
    bad = L.clone()
    bad[2, 99] ^= 1
    assert batched.verify_bwt_batched(data2, rank, bad, base, "large").tolist() == [
        True, True, False, True]
    assert batched.verify_bwt_batched(data2, rank, L, base + 1, "large").tolist() == [False] * 4


def _text_block(n, device):
    return torch.from_numpy(np.frombuffer(text_like(n, 9), np.uint8).copy()).to(device)


@pytest.mark.parametrize("shape", ["it2_stage1", "it2_merge", "sais_joint_rank", "it2_reduced"])
def test_kernels_match_twins_at_it2_and_sais_shapes(cuda_device, shape):
    """The sorts the IT-2 and SA-IS paths add, with the keys a 4 MiB text
    block gives them: 5 keys + index with 2 payloads at 2^22 (a fifth key
    past the carried four, first and last in significance), 2 keys + index
    at 2^23 + 2, 1 key + 1 payload at 2^21."""
    from archon_tpu_torch.core import it2, sais_tpu

    n = 1 << 22
    data = _text_block(n, cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    if shape == "sais_joint_rank":
        d = data.to(torch.int32)
        t = sais_tpu._types(d)
        u = torch.cat([d * 2 + t[:n].to(torch.int32) + 2, d.new_ones(1)])
        lms = torch.cat([t.new_zeros(1), t[1:] & ~t[:-1]])
        keys = [torch.cat([u, u]), torch.cat([torch.zeros_like(u),
                                          torch.where(lms, 1, 0x3FFFFFFF).to(torch.int32)])]
        payloads = [torch.arange(2 * n + 2, dtype=torch.int32, device=cuda_device)]
        assert keys[0].shape[0] == (1 << 23) + 2
    else:
        M = it2._reduced_capacity(n)
        assert M == 1 << 21
        pkeys, dist, s1, bad, overflow = it2._it2_stage1(data, 11, M)
        assert len(pkeys) == 4 and not bool(bad) and not bool(overflow)
        if shape == "it2_stage1":
            lucky = it2._lucky_mask(data.to(torch.int32))
            keys, payloads = [torch.where(lucky, 0, 1).to(torch.int32), *pkeys], [iota, dist]
        elif shape == "it2_merge":
            r_star = fast2.suffix_ranks_windows(s1, 1, "small")
            c = torch.cumsum(it2._lucky_mask(data.to(torch.int32)), 0).to(torch.int32)
            refkey = torch.where(dist <= 11, torch.where(c < c[-1], r_star[c.clamp(max=M - 1)], -1),
                                 0x7FFFFFFF)
            keys, payloads = [*pkeys, refkey], [iota, torch.roll(data, 1)]
        else:
            keys, payloads = [s1], [torch.arange(M, dtype=torch.int32, device=cuda_device)]
    _hold_kernels_to_twins([k.contiguous() for k in keys], payloads)


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_v1_it2_sais_on_card_match_cpu(cuda_device, sentinel):
    """``suffix_array_fast``, ``bwt_sais`` and ``bwt_it2`` at 2^20 on the card
    against the same functions on CPU tensors (the plain twins), and
    against ``bwt_v3`` on the card."""
    from archon_tpu_torch.core import fast, it2, sais_tpu

    n = 1 << 20
    cpu = _text_block(n, "cpu")
    dev = cpu.to(cuda_device)
    launches = tsort.sort_tiles.launches
    sa = fast.suffix_array_fast(dev, sentinel, return_device=True)
    assert sa.device.type == "cuda"
    assert np.array_equal(sa.cpu().numpy(), fast.suffix_array_fast(cpu, sentinel))
    Lw, bw = fast2.bwt_v3(dev, sentinel)
    L, base = sais_tpu.bwt_sais(dev, sentinel)
    Lc, basec = sais_tpu.bwt_sais(cpu, sentinel)
    assert torch.equal(L.cpu(), Lc) and base == basec
    assert torch.equal(L, Lw) and base == bw
    L, base, ok = it2.bwt_it2(dev, sentinel)
    Lc, basec, okc = it2.bwt_it2(cpu, sentinel)
    assert ok and okc and torch.equal(L.cpu(), Lc) and base == basec
    assert torch.equal(L, Lw) and base == bw
    assert tsort.sort_tiles.launches > launches + 20


def test_it2_container_on_card_matches_stream(cuda_device):
    """``impl="it2"`` on the card: text blocks through IT-2, a zero run
    through the counted ``bwt_v3`` fallback, the stream's bytes either way."""
    from archon_tpu_torch.io import blocks

    n = 1 << 17
    data = text_like(2 * n, 3) + bytes(n) + text_like(n + 777, 4)
    blocks._streamed_forward.it2_fallbacks = 0
    got = blocks.encode_file(data, "a7", n, impl="it2", device=cuda_device)
    assert blocks._streamed_forward.it2_fallbacks == 1
    assert got == blocks.encode_file(data, "a7", n, impl="stream", device=cuda_device)
    assert blocks.decode_file(got) == data


def _card_mesh(cuda_device, ns=8):
    from archon_tpu_torch.parallel.blocks import make_mesh

    return make_mesh({"sp": ns}, devices=[cuda_device] * ns)


@pytest.mark.parametrize("n", [1 << 20, 1_000_000], ids=["aligned", "ragged"])
def test_megablock_sort_shapes_match_twins_on_card(cuda_device, monkeypatch, n):
    """Every sort a ``bwt_megablock`` of 8 shards launches (5, 2 and 1 keys;
    ``sort_rows`` at (8, S), the stages' ``stage_merge`` of (8, S) rows with
    their partners' rows in place) against its twin, bit for bit; each stage
    one ``stage_merge`` call (its split pass and its merge) and no K1 or K2
    launch.  At 1 MiB S is a multiple of the stage's 2048-output tile; at
    10^6 B S = 125,000 is not (S mod 2048 = 72), so each row's last tile is
    masked.  (L, base) equals ``bwt_v3``'s."""
    from archon_tpu_torch.parallel import megablock as mb

    seen = {"sort_rows": [], "stage_merge": []}
    real_sort, real_stage = mb.sort_rows, mb.stage_merge
    monkeypatch.setattr(mb, "sort_rows", lambda k, p=(): seen["sort_rows"].append(
        (list(k), list(p))) or real_sort(k, p))

    def stage(mine, partner, rows, keep_low, nk):
        before = (tsort.sort_tiles.launches, tsort.merge_level.launches, real_stage.launches)
        out = real_stage(mine, partner, rows, keep_low, nk)
        launches = (tsort.sort_tiles.launches, tsort.merge_level.launches, real_stage.launches)
        seen["stage_merge"].append((list(mine), list(partner), rows, keep_low, nk, out, before,
                                    launches))
        stage.launches = real_stage.launches
        return out

    stage.launches = real_stage.launches
    monkeypatch.setattr(mb, "stage_merge", stage)
    block = np.frombuffer(text_like(n, 6), np.uint8)
    mb.stats.reset()
    L, base = mb.bwt_megablock(block, _card_mesh(cuda_device), "small")
    Lw, bw = fast2.bwt_v3(torch.from_numpy(block.copy()).to(cuda_device), "small")
    assert torch.equal(L.reshape(-1), Lw) and base == bw
    monkeypatch.undo()
    S = n // 8
    assert {(len(k), len(p), tuple(k[0].shape)) for k, p in seen["sort_rows"]} == {
        (5, 0, (8, S)), (2, 0, (8, S)), (1, 1, (8, S))}
    assert {(nk, len(mine) - nk, tuple(mine[0].shape)) for mine, *_, nk, _, _, _ in
            seen["stage_merge"]} == {(5, 0, (8, S)), (2, 0, (8, S)), (1, 1, (8, S))}
    assert mb.stats.stage_kernel == mb.stats.stages == len(seen["stage_merge"]) > 0
    for keys, payloads in seen["sort_rows"][:6]:
        got, want = tsort.sort_rows(keys, payloads), tsort.sort_rows_ref(keys, payloads)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for mine, partner, rows, keep_low, nk, out, before, after in seen["stage_merge"]:
        assert after == (before[0], before[1], before[2] + 1)
        assert all(partner[j] is mine[j] for j in range(len(mine)))  # in process: in place
    for mine, partner, rows, keep_low, nk, out, _, _ in seen["stage_merge"][:8] + seen["stage_merge"][-8:]:
        want = tsort.stage_merge_ref(mine, partner, rows, keep_low, nk)
        assert all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(out, want))


@pytest.mark.parametrize("nk,pay", [(5, None), (1, torch.int32), (1, torch.uint8)],
                         ids=["5keys", "1key-int32", "1key-uint8"])
def test_stage_merge_at_the_enwik8_stage_shape(cuda_device, nk, pay):
    """One merge-split stage of a 10^8-byte megablock over 8 shards:
    ``stage_merge`` of (8, 12,500,000) rows, each row's partner row ``b ^ 1``
    of the same tensors, rows keeping the low half and rows keeping the high
    half, against ``stage_merge_ref`` bit for bit; real all-0x7FFFFFFF
    elements in both runs; one call, no K1 or K2 launch."""
    B, S = 8, 12_500_000
    g = torch.Generator(device=cuda_device).manual_seed(18)
    keys = [torch.randint(0, 3 if nk > 1 else 1000, (B, S), generator=g, dtype=torch.int32,
                          device=cuda_device) for _ in range(min(nk, 4))]
    if nk == 5:  # the megablock's fifth key is a position: unique
        keys.append(torch.randperm(B * S, generator=g, device=cuda_device)
                    .to(torch.int32).view(B, S))
    for k in keys:
        k[:, 7::9973] = tsort.PAD_KEY
    payloads = [] if pay is None else [torch.randint(-(1 << 31) if pay == torch.int32 else 0,
                                                     (1 << 31) - 1 if pay == torch.int32 else 256,
                                                     (B, S), generator=g, device=cuda_device,
                                                     dtype=pay)]
    mine = tsort.sort_rows(keys, payloads)
    del keys, payloads
    rows = [b ^ 1 for b in range(B)]
    keep_low = torch.tensor([[b % 3 != 1] for b in range(B)], device=cuda_device)
    before = (tsort.sort_tiles.launches, tsort.merge_level.launches, tsort.stage_merge.launches)
    got = tsort.stage_merge(mine, mine, rows, keep_low, nk)
    after = (tsort.sort_tiles.launches, tsort.merge_level.launches, tsort.stage_merge.launches)
    assert after == (before[0], before[1], before[2] + 1)
    want = tsort.stage_merge_ref(mine, mine, rows, keep_low, nk)
    assert all(x.dtype == w.dtype and torch.equal(x, w) for x, w in zip(got, want))


@pytest.mark.parametrize("nk,npay", [(5, 0), (1, 1)], ids=["5keys", "1key-payload"])
def test_merge_rows_at_the_enwik8_stage_shape(cuda_device, nk, npay):
    """One merge-split stage of a 10^8-byte megablock over 8 shards:
    ``merge_rows`` at (8, 2 x 12,500,000), each run padded by 992 tuples, is
    ONE K2 launch and no K1, and equals the stage re-sorted by ``sort_rows``
    bit for bit; real all-0x7FFFFFFF tuples are planted in both runs."""
    B, S = 8, 12_500_000
    g = torch.Generator(device=cuda_device).manual_seed(12)
    keys = [torch.randint(0, 3 if nk > 1 else 1000, (2 * B, S), generator=g, dtype=torch.int32,
                          device=cuda_device) for _ in range(min(nk, 4))]
    if nk == 5:  # the megablock's fifth key is a position: unique
        keys.append(torch.randperm(2 * B * S, generator=g, device=cuda_device)
                    .to(torch.int32).view(2 * B, S))
    for k in keys:
        k[:, 7::9973] = tsort.PAD_KEY
    payloads = [torch.randint(0, 256, (2 * B, S), generator=g, device=cuda_device,
                              dtype=torch.uint8) for _ in range(npay)]
    runs = tsort.sort_rows(keys, payloads)  # row 2b and 2b + 1: the two runs of stage row b
    del keys, payloads
    rows = [r.reshape(B, 2 * S) for r in runs]
    del runs
    before = (tsort.sort_tiles.launches, tsort.merge_level.launches, tsort.merge_rows.pad)
    got = tsort.merge_rows(rows[:nk], rows[nk:])
    after = (tsort.sort_tiles.launches, tsort.merge_level.launches, tsort.merge_rows.pad)
    assert after == (before[0], before[1] + 1, before[2] + B * 2 * 992)
    want = tsort.sort_rows(rows[:nk], rows[nk:])
    assert all(x.dtype == w.dtype and torch.equal(x, w) for x, w in zip(got, want))


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_bwt_megablock_on_card_matches_bwt_v3(cuda_device, sentinel):
    """1 MiB of text and 2^18 zeros as 8 shards in process on the card."""
    from archon_tpu_torch.parallel import megablock as mb

    mesh = _card_mesh(cuda_device)
    for block in (np.frombuffer(text_like(1 << 20, 7), np.uint8), np.zeros(1 << 18, np.uint8)):
        launches = (tsort.sort_tiles.launches, tsort.merge_level.launches)
        L, base = mb.bwt_megablock(block, mesh, sentinel)
        assert L.device.type == "cuda" and L.shape == (8, len(block) // 8)
        Lw, bw = fast2.bwt_v3(torch.from_numpy(block.copy()).to(cuda_device), sentinel)
        assert torch.equal(L.reshape(-1), Lw) and base == bw
        assert tsort.sort_tiles.launches > launches[0] and tsort.merge_level.launches > launches[1]


def test_megapipe_on_card_writes_the_cpu_blob(cuda_device):
    """``encode_megablock`` on the card (pad > 0, both coders) against the
    same call on CPU tensors; each blob decodes to the input."""
    from archon_tpu_torch.parallel import megapipe
    from archon_tpu_torch.parallel.blocks import make_mesh

    data = text_like((1 << 18) - 5, 8)
    cpu_mesh = make_mesh({"sp": 8}, devices=["cpu"] * 8)
    for gen, coder in (("a4", "var"), ("a7", "byte")):
        blob = megapipe.encode_megablock(data, _card_mesh(cuda_device), gen, coder)
        assert blob == megapipe.encode_megablock(data, cpu_mesh, gen, coder)
        assert megapipe.decode_megablock(blob) == data


def test_unbwt_blocks_on_card_matches_row_loop(cuda_device):
    from archon_tpu_torch.parallel import blocks as pblocks

    rows = torch.stack([torch.from_numpy(np.frombuffer(text_like(1 << 16, seed), np.uint8).copy())
                        for seed in (1, 2, 3)]).to(cuda_device)
    L, base = pblocks.bwt_blocks(rows, "large")
    got = pblocks.unbwt_blocks(L, base, "large")
    loop = torch.stack([unbwt.bwt_inverse(L[b], int(base[b]), "large") for b in range(3)])
    assert torch.equal(got, loop) and torch.equal(got, rows.flip(1))


def _pack_tables(head: np.ndarray):
    """Each row's code table as ``RowPack`` builds it, for the rows with two
    symbols or more: (codes, lens, row_word, total words)."""
    from archon_tpu_torch.entropy import pack

    B = head.shape[0]
    codes = np.zeros((B, pack.NSYM), np.uint32)
    lens = np.zeros((B, pack.NSYM), np.int32)
    row_word = np.full(B, -1, np.int64)
    total = 0
    for b in range(B):
        hist = head[b, : pack.NSYM].astype(np.int64)
        present = np.nonzero(hist)[0]
        if len(present) > 1:
            codes[b], lens[b], _maxlen = pack._codes_for(present, hist[present])
            row_word[b] = total
            total += (int(hist @ lens[b]) + 31) // 32
    return (torch.from_numpy(codes.view(np.int32)), torch.from_numpy(lens),
            torch.from_numpy(row_word), total)


def _hold_pack_to_twins(L: torch.Tensor, chunk: int) -> None:
    """mtf_rle and pack_words on the card against their twins: every
    chunk's table and symbols, the heads, each row's stream and the words;
    both must launch."""
    from archon_tpu_torch.ops import pack as ops_pack

    before = (ops_pack.mtf_rle.launches, ops_pack.pack_words.launches)
    got = ops_pack.mtf_rle(L, chunk)
    want = ops_pack.mtf_rle_ref(L.cpu(), chunk)
    for field in ("meta", "chist", "head"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field)), field
    for g, w in zip(ops_pack.symbols(got), ops_pack.symbols(want)):
        assert torch.equal(g, w)
    codes, lens, row_word, total = _pack_tables(want.head.numpy())
    words = ops_pack.pack_words(got, codes.to(L.device), lens.to(L.device), row_word.to(L.device),
                                total)
    assert torch.equal(words.cpu(), ops_pack.pack_words_ref(want, codes, lens, row_word, total))
    assert ops_pack.mtf_rle.launches == before[0] + 1
    assert ops_pack.pack_words.launches == before[1] + 1


def _pack_rows(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    runs = np.concatenate([[9] * k + [200, 9] + [200] * k + [3] + [3] * k for k in range(1, 140)])
    return np.stack([
        np.resize(runs, n).astype(np.uint8),
        np.resize(rng.permutation(256).astype(np.uint8), n),
        np.full(n, 77, np.uint8),
        np.frombuffer(text_like(n, 5), np.uint8),
        np.repeat(rng.integers(0, 256, n), rng.integers(1, 40, n))[:n].astype(np.uint8),
    ])


@pytest.mark.parametrize("chunk", [7, 64, 997, 4096])
@pytest.mark.parametrize("n", [1, 20_011])
def test_pack_kernels_match_twins_on_card(cuda_device, chunk, n):
    _hold_pack_to_twins(torch.from_numpy(_pack_rows(n)).to(cuda_device), chunk)


def test_pack_kernels_on_a_text_bwt(cuda_device):
    """A 4 MiB Zipf-text BWT row against the twins; an (8, 4 MiB) unit of
    them through ``RowPack``, equal to ``pack_block`` row by row."""
    from archon_tpu_torch.entropy import pack
    from archon_tpu_torch.ops import pack as ops_pack
    from portbench.gen.zipf_text import zipf_text

    n = 1 << 22
    rows = [fast2.bwt_v3(torch.from_numpy(np.frombuffer(zipf_text(n, 2**31 + s), np.uint8).copy())
                         .to(cuda_device), "small")[0] for s in range(8)]
    _hold_pack_to_twins(rows[0][None].contiguous(), ops_pack.PACK_CHUNK)
    L = torch.stack(rows)
    device_blocks = pack.stats.device_blocks
    got = pack.RowPack(L).payloads(list(range(8)))
    assert got == [pack.pack_block(row) for row in L.cpu().numpy()]
    assert pack.stats.device_blocks == device_blocks + 8
    assert all(p[0] == 1 for p in got)


def test_packed_container_on_card_equals_the_host_pack(cuda_device):
    """A Silesia-sized file (dickens, 10,192,446 bytes: 2 blocks and a
    ragged tail) packed on the card, byte for byte the host pack's."""
    from archon_tpu_torch.entropy import pack
    from archon_tpu_torch.io import blocks
    from archon_tpu_torch.ops import pack as ops_pack
    from portbench.gen.zipf_text import zipf_text

    data = zipf_text(10_192_446, 2**31 + 77)
    before = (ops_pack.mtf_rle.launches, ops_pack.pack_words.launches, pack.stats.device_blocks)
    got = blocks.encode_file(data, "a4", pack=True, device=cuda_device)
    assert (ops_pack.mtf_rle.launches - before[0], ops_pack.pack_words.launches - before[1],
            pack.stats.device_blocks - before[2]) == (2, 2, 3)
    assert got == blocks.encode_file(data, "a4", impl="stream", pack=True, device=cuda_device)
    assert blocks.decode_file(got) == data
