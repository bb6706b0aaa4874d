"""CUDA kernels and the forward BWT on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card.  The file
imports no JAX, so on a GPU machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from archon_tpu.golden import sa as golden
from archon_tpu_torch.core import fast2
from archon_tpu_torch.ops import sort as tsort

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,nk,hi", [(1, 3, 5), (4096, 49, 3), (100_003, 4, 1000),
                                     ((1 << 22) - 17, 4, 1 << 16)])
def test_kernels_match_twins_on_card(cuda_device, n, nk, hi):
    rng = np.random.default_rng(n)
    keys = [torch.from_numpy(rng.integers(-1, hi, n).astype(np.int32)).to(cuda_device)
            for _ in range(nk)]
    mat = torch.stack(keys)
    before = (tsort.sort_tiles.launches, tsort.merge_level.launches)
    perm = tsort.sort_tiles(mat)
    assert torch.equal(perm, tsort.sort_tiles_ref(mat))
    run = tsort.TILE
    while run < perm.shape[0]:
        nxt = tsort.merge_level(mat, perm, run)
        assert torch.equal(nxt, tsort.merge_level_ref(mat, perm, run))
        perm, run = nxt, 2 * run
    got = tsort.sort_operands(keys, [keys[0]])
    want = tsort.sort_operands_ref(keys, [keys[0]])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tsort.sort_tiles.launches > before[0]


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
