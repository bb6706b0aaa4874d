"""The port's mesh and what hangs on it: ``make_mesh`` (a device may repeat),
``mesh=`` on the functions of ``parallel/blocks.py``, ``encode_file(dp=)``,
the (B, n) inverse against the row loop and the JAX function, and the faults
repaired with it (``formats.encode`` takes the device certificate,
``decode_file`` pools only over the native walk, ``__version__``).  Bytes and
integers compared exactly; every port call runs on the CPU."""

import numpy as np
import pytest
import torch

import archon_tpu
import archon_tpu_torch
from archon_tpu import formats as jformats
from archon_tpu.parallel import blocks as jpblocks
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import formats, native
from archon_tpu_torch.core import batched, unbwt
from archon_tpu_torch.io import blocks
from archon_tpu_torch.parallel import blocks as pblocks
from archon_tpu_torch.parallel.dryrun import dryrun_multichip

BLOCK = 2048
TEXT = text_like(9 * BLOCK + 700, 5)  # nine whole blocks and a short last one
IMPLS = ["micro", "v3", "stream", "it2"]


def _cpu_mesh(n, axis="dp"):
    return pblocks.make_mesh({axis: n}, devices=["cpu"] * n)


def test_make_mesh(monkeypatch):
    mesh = _cpu_mesh(8)
    assert (mesh.axes, mesh.shape, mesh.size) == (("dp",), {"dp": 8}, 8)
    assert mesh.devices == [torch.device("cpu")] * 8 and mesh.group is None
    assert pblocks.make_mesh(devices=["cpu"] * 3).shape == {"dp": 3}  # the default axis
    two = pblocks.make_mesh({"dp": 2, "sp": 4}, devices=["cpu"] * 8)
    assert two.axes == ("dp", "sp") and two.shape["sp"] == 4
    with pytest.raises(ValueError, match="cannot lay 8 devices"):
        pblocks.make_mesh({"dp": 3}, devices=["cpu"] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pblocks.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in pblocks.make_mesh().devices] == ["cuda:0", "cuda:1"]


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_file_dp_writes_the_bytes_of_dp_1(impl, monkeypatch):
    want = blocks.encode_file(TEXT, "a4", BLOCK, impl=impl, device="cpu")
    sharded = []
    real = pblocks._over_mesh
    monkeypatch.setattr(pblocks, "_over_mesh", lambda fn, mesh, *t: sharded.append(
        (mesh.size if mesh else 0, t[0].shape[0])) or real(fn, mesh, *t))
    for dp in (2, 8):
        del sharded[:]
        assert blocks.encode_file(TEXT, "a4", BLOCK, impl=impl, dp=dp, device="cpu") == want
        if impl in ("micro", "v3"):
            # units of 8 rows: one over the mesh; the ninth block and the short one unsharded
            assert sharded == [(dp, 8), (0, 1), (0, 1)]
        else:
            assert not sharded  # the stream ignores dp
    assert want == archon_tpu.encode_file(TEXT, "a4", BLOCK, impl=impl, dp=2)


def test_dp_unit_is_rounded_up_to_the_mesh(monkeypatch):
    """ARCHON_PIPE_BLOCKS=3 under dp=2: units of 4 rows, the ragged tail of
    one row unsharded."""
    seen = []
    real = pblocks.bwt_blocks_micro
    monkeypatch.setattr(pblocks, "bwt_blocks_micro", lambda d, s, mesh=None: seen.append(
        (d.shape[0], mesh.size if mesh else 0)) or real(d, s, mesh=mesh))
    monkeypatch.setenv("ARCHON_PIPE_BLOCKS", "3")
    got = blocks.encode_file(TEXT, "a7", BLOCK, verify=False, dp=2, device="cpu")
    assert seen == [(4, 2), (4, 2), (1, 0), (1, 0)]
    assert got == blocks.encode_file(TEXT, "a7", BLOCK, device="cpu")


def test_dp_on_cuda_takes_the_first_cards_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="dp=2 needs 2 CUDA devices, this machine has 1"):
        blocks._dp_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [str(d) for d in blocks._dp_mesh(2, "cuda").devices] == ["cuda:0", "cuda:1"]
    assert blocks._dp_mesh(1, "cuda") is None
    assert blocks._dp_mesh(5, "cpu").size == 5  # the CPU takes any dp


@pytest.mark.parametrize("name", ["bwt_blocks", "bwt_blocks_certified", "bwt_blocks_micro",
                                  "bwt_blocks_micro_certified"])
def test_mesh_on_the_forward_functions(name):
    rows = torch.from_numpy(np.frombuffer(TEXT[: 8 * BLOCK], np.uint8).reshape(8, BLOCK).copy())
    fn = getattr(pblocks, name)
    want = fn(rows, "large")
    for size in (2, 8):
        got = fn(rows, "large", mesh=_cpu_mesh(size))
        assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    jax_out = getattr(jpblocks, name)(rows.numpy(), "large")
    assert all(np.array_equal(g.numpy(), np.asarray(j)) for g, j in zip(want, jax_out))
    with pytest.raises(ValueError, match="8 rows do not divide over a mesh of 3"):
        fn(rows, "large", mesh=_cpu_mesh(3))


@pytest.mark.parametrize("sentinel", ["small", "large"])
@pytest.mark.parametrize("n", [5000, 20000], ids=["doubling", "lockstep"])
def test_unbwt_blocks_rows_at_once(n, sentinel):
    """The (B, n) inverse (one lockstep loop for all rows) against the row
    loop, the input and the JAX function; with a mesh too."""
    rng = np.random.default_rng(n)
    rows = np.stack([np.frombuffer(text_like(n, seed=s), np.uint8) for s in (1, 2)]
                    + [rng.integers(0, 2, n, dtype=np.uint8), np.zeros(n, np.uint8)])
    L, base = pblocks.bwt_blocks(torch.from_numpy(rows), sentinel)
    got = pblocks.unbwt_blocks(L, base, sentinel)
    loop = torch.stack([unbwt.bwt_inverse(L[b], int(base[b]), sentinel) for b in range(4)])
    assert got.dtype == torch.uint8 and torch.equal(got, loop)
    assert np.array_equal(got.numpy(), rows[:, ::-1])
    assert torch.equal(pblocks.unbwt_blocks(L, base.tolist(), sentinel, mesh=_cpu_mesh(2)), got)
    P = unbwt.lf_successor(L, base, sentinel)
    assert P.dtype == torch.int32
    assert torch.equal(P, torch.stack([unbwt.lf_successor(L[b], int(base[b]), sentinel)
                                       for b in range(4)]))
    want = jpblocks.unbwt_blocks(L.numpy(), base.numpy(), sentinel)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_unbwt_blocks_of_nothing():
    empty = torch.zeros((0, 7), dtype=torch.uint8)
    assert pblocks.unbwt_blocks(empty, []).shape == (0, 7)
    assert pblocks.unbwt_blocks(torch.zeros((3, 0), dtype=torch.uint8), [0, 0, 0]).shape == (3, 0)


@pytest.mark.parametrize("generation", ["a4", "a7"])
def test_formats_encode_takes_the_device_certificate(generation, monkeypatch):
    data = TEXT[:5000]
    monkeypatch.setattr(formats, "_inverse", None)  # no host round trip in encode
    want = jformats.encode(data, generation)
    assert formats.encode(data, generation, device="cpu") == want
    assert formats.encode(data, generation, verify=False, device="cpu") == want
    real = batched._bwt_batched_v3_impl

    def corrupt(data2, prev2, sentinel, want_rank):
        out = real(data2, prev2, sentinel, want_rank)
        out[0][0, 1234] ^= 0xFF
        return out

    monkeypatch.setattr(batched, "_bwt_batched_v3_impl", corrupt)
    with pytest.raises(AssertionError, match="BWT verification failed"):
        formats.encode(data, generation, device="cpu")
    assert formats.encode(data, generation, verify=False, device="cpu") != want


@pytest.mark.parametrize("with_native", [True, False], ids=["native", "no_native"])
def test_decode_file_pools_only_over_the_native_walk(with_native, monkeypatch):
    blob = blocks.encode_file(TEXT[: 3 * BLOCK], "a4", BLOCK, device="cpu")
    if with_native and not native.available():
        pytest.skip("no C++ toolchain: the native library did not build")
    if not with_native:
        monkeypatch.setattr(native, "available", lambda: False)
    pools = []
    real = blocks.ThreadPoolExecutor
    monkeypatch.setattr(blocks, "ThreadPoolExecutor",
                        lambda **kw: pools.append(kw) or real(**kw))
    assert blocks.decode_file(blob) == TEXT[: 3 * BLOCK]
    assert len(pools) == (1 if with_native else 0)
    assert blocks.decode_file(blocks.encode_file(TEXT[:BLOCK], "a4", BLOCK, device="cpu")) == TEXT[:BLOCK]
    assert len(pools) == (1 if with_native else 0)  # one block: no pool either way


def test_version_is_the_jax_packages():
    assert archon_tpu_torch.__version__ == archon_tpu.__version__ == "0.4.0"
    assert "__version__" in archon_tpu_torch.__all__
    assert sorted(archon_tpu_torch.__all__) == sorted(archon_tpu.__all__)


def test_dryrun_multichip_on_the_cpu(monkeypatch):
    dryrun_multichip(8, device="cpu")
    dryrun_multichip(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(8)  # the default device is the card: no quiet step to the CPU
