"""archon_tpu_torch -- the PyTorch/CUDA port of archon_tpu for NVIDIA Hopper.

The forward BWT (``core.fast2.bwt_v3``) runs on torch tensors; its sorts go
through hand-written CUDA kernels (``csrc/sort.cu``: a per-tile bitonic
sort and merge-path merge levels, ports of ``archon_tpu/ops/pallas_sort.py``)
on CUDA tensors, and through their plain PyTorch twins on CPU tensors.
Output is byte-identical with the JAX package.  The package imports no JAX:
it reuses only ``archon_tpu``'s host-side modules (``native``, ``entropy``,
``golden``, ``config.ArchonConfig`` and the container framing constants),
which import none either, all through ``host``.

There are no weights and no learned state to carry between the packages:
both take the same input bytes and the same configuration (generation
a4/a7, block size, pack), and the port uses ``archon_tpu.config.ArchonConfig``
as it is, so no converter exists or is needed.

Top-level API (lazily imported).  Every function that runs on a device
takes ``device``, default ``"cuda"``, and raises when that device is
unavailable; decoding runs on the host:

    encode(data, generation, device=...)      / decode(blob, generation)
    encode_file(data, generation, block_size, verify, pack, device=...)
    decode_file(blob, strict, on_error)
"""

from __future__ import annotations

_LAZY = {
    "encode": ("archon_tpu_torch.formats", "encode"),
    "decode": ("archon_tpu_torch.formats", "decode"),
    "encode_file": ("archon_tpu_torch.io.blocks", "encode_file"),
    "decode_file": ("archon_tpu_torch.io.blocks", "decode_file"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'archon_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__
