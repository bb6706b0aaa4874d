"""The JAX package's host-side code that the port shares rather than copies.

Every name here comes from a module of ``archon_tpu`` that imports no JAX
(that package's ``__init__`` is lazy): the native C++ LF walk and pack
library, the entropy pack, the a6 Huffman/fixed/byte code tables and
alphabet-order heuristics, the numpy golden models, the configuration and
the container framing.  The port reaches ``archon_tpu``
through this module only, so the seam between the two packages is one file.
"""

from __future__ import annotations

from archon_tpu import native
from archon_tpu.config import ArchonConfig
from archon_tpu.entropy.huffman import (
    build_encoder_byte,
    build_encoder_fixed,
    build_encoder_var,
)
from archon_tpu.entropy.order import order_table
from archon_tpu.entropy.pack import unpack_block
from archon_tpu.golden import sa as golden
from archon_tpu.io.blocks import (
    DEFAULT_BLOCK,
    FLAG_PACKED,
    GENERATIONS,
    MAGIC,
    MAGIC_PACKED,
    PIPE_BLOCKS,
    _pack_payloads,
)

__all__ = [
    "ArchonConfig",
    "DEFAULT_BLOCK",
    "FLAG_PACKED",
    "GENERATIONS",
    "MAGIC",
    "MAGIC_PACKED",
    "PIPE_BLOCKS",
    "build_encoder_byte",
    "build_encoder_fixed",
    "build_encoder_var",
    "golden",
    "native",
    "order_table",
    "unpack_block",
    "_pack_payloads",
]
