"""Multi-device dry run on tiny shapes (the port's twin of the JAX package's
``dryrun_multichip`` entry point): the dp round trip, the sharded suffix
array on random bytes and on zeros, and the megapipe round trip, each on a
mesh of ``n_devices`` entries of one device."""

from __future__ import annotations

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run every multi-device path once on a mesh of ``n_devices`` entries of
    ``device`` and hold each result to the golden model; raises on the first
    difference."""
    from ..golden.sa import suffix_array as golden_sa
    from ..io.blocks import as_device
    from ..utils.corpus import text_like
    from .blocks import bwt_blocks, make_mesh, unbwt_blocks
    from .megablock import suffix_array_sharded
    from .megapipe import decode_megablock, encode_megablock

    dev = as_device(device)
    devices = [dev] * n_devices

    # dp sharding over independent blocks: the block-streaming strategy
    # mapped onto the mesh
    mesh = make_mesh({"dp": n_devices}, devices=devices)
    rng = np.random.default_rng(1)
    blocks = torch.from_numpy(rng.integers(0, 256, (2 * n_devices, 512), dtype=np.uint8)).to(dev)
    L, base = bwt_blocks(blocks, "small", mesh=mesh)
    rt = unbwt_blocks(L, base, "small", mesh=mesh)
    if not torch.equal(rt, blocks.flip(1)):
        raise AssertionError("dp round trip failed")

    # sharded-megablock mode: distributed prefix doubling over the 'sp' axis
    sp_mesh = make_mesh({"sp": n_devices}, devices=devices)
    arr = rng.integers(0, 8, 128 * n_devices, dtype=np.uint8)
    if not np.array_equal(suffix_array_sharded(arr, sp_mesh, "small"), golden_sa(arr, "small")):
        raise AssertionError("sharded suffix array differs from the golden model's")

    # tie group spanning every shard: exact by merge-split construction
    zeros = np.zeros(128 * n_devices, np.uint8)
    if not np.array_equal(suffix_array_sharded(zeros, sp_mesh, "small"),
                          golden_sa(zeros, "small")):
        raise AssertionError("sharded suffix array of zeros differs from the golden model's")

    # end-to-end sharded file pipeline: text sharded over 'sp' -> distributed
    # doubling SA -> sharded BWT emission -> per-shard Huffman pack ->
    # container -> host decode -> byte-identical
    data = text_like(512 * n_devices, seed=2)
    blob = encode_megablock(data, sp_mesh, "a4", "var")
    if decode_megablock(blob) != data:
        raise AssertionError("sharded megapipe round-trip failed")
