"""archon_tpu_torch -- the PyTorch/CUDA port of archon_tpu for NVIDIA Hopper.

The forward BWT (``core.fast2.bwt_v3``; the v1 sorters ``core.doubling`` and
``core.fast``, the induced-sorting path ``core.sais_tpu`` and the IT-2
reduced-volume path ``core.it2`` beside it), the a6 compressor (``core.a6``)
and the device inverse BWT (``core.unbwt``) run on torch tensors; their sorts
go through hand-written CUDA kernels (``csrc/sort.cu``: a per-tile bitonic
sort and merge-path merge levels, ports of ``archon_tpu/ops/pallas_sort.py``)
on CUDA tensors, and through their plain PyTorch twins on CPU tensors.
Output is byte-identical with the JAX package.  The package imports no JAX
and nothing of ``archon_tpu``: the host-side modules it needs (``native``
with its C++ source, ``entropy``, ``golden``, ``ops.itn``, ``ops.sais``,
``utils``, ``config.ArchonConfig`` and the container framing) are its own
copies, under the JAX package's names.

There are no weights and no learned state to carry between the packages:
both take the same input bytes and the same configuration (generation
a4/a7, block size, pack, impl in micro, v3, stream, it2, dp, sp), and
``config.ArchonConfig`` has the JAX package's fields, so no converter exists
or is needed.  What is carried across is the format: every ATA1, ATA2 and
ATM1 blob either package writes, the other reads.

Several devices: ``parallel.blocks.make_mesh(axes, devices)`` builds the
port's own small ``Mesh`` (a device may stand in it more than once).
``encode_file(dp=N)`` splits each batch of blocks over a ``dp`` mesh;
``parallel.megapipe.encode_megablock(data, mesh, generation, coder)`` sorts
the input as ONE block across the shards of an ``sp`` mesh (distributed
prefix doubling, ``parallel.megablock``) and writes the ``ATM1`` container,
which ``decode_megablock`` reads on the host.  Shards on one device run in
process, as the rows of one tensor; a mesh made with a ``torch.distributed``
process group runs one rank a device (``parallel.collectives``).

Top-level API (lazily imported).  Every function that runs on a device
takes ``device``, default ``"cuda"``, and raises when that device is
unavailable; ``decode`` walks on the host unless given a device, and
``decode_file`` walks on the host:

    encode(data, generation, device=...)      / decode(blob, generation, device=None)
    a6_encode(data, config, order, device=...) / a6_decode(blob, config, order, device=...)
    encode_file(data, generation, block_size, verify, impl, dp, pack, device=...)
    encode_to_path(data, path, ..., resume, flush_blocks, verify, impl, pack, device=...)
    decode_file(blob, strict, on_error)
    ArchonConfig                              # the configuration dataclass
    __version__                               # the JAX package's
"""

from __future__ import annotations

__version__ = "0.4.0"

_LAZY = {
    "encode": ("archon_tpu_torch.formats", "encode"),
    "decode": ("archon_tpu_torch.formats", "decode"),
    "encode_file": ("archon_tpu_torch.io.blocks", "encode_file"),
    "encode_to_path": ("archon_tpu_torch.io.blocks", "encode_to_path"),
    "decode_file": ("archon_tpu_torch.io.blocks", "decode_file"),
    "a6_encode": ("archon_tpu_torch.core.a6", "a6_encode"),
    "a6_decode": ("archon_tpu_torch.core.a6", "a6_decode"),
    "ArchonConfig": ("archon_tpu_torch.config", "ArchonConfig"),
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'archon_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__
