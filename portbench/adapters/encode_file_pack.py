"""Adapter for ``archon_tpu_torch.encode_file(..., pack=True)``: the
compressing ATA2 container, each block's L entropy-packed on the host.

The configuration's ``call`` holds the arguments, as for ``encode_file``.
A request is one file; its rows are its blocks.
"""

from __future__ import annotations

from portbench.adapters.encode_file import SPANS  # noqa: F401  (the same layer functions)
from portbench.reference import ata2


class Adapter:
    diff = staticmethod(ata2.diff)
    summary = staticmethod(ata2.summary)

    def __init__(self, call: dict, device):
        import archon_tpu_torch

        if not call["pack"]:
            raise ValueError("the reference writes ATA2 only; pack must be true")
        self.call = call
        self.device = device
        self._encode_file = archon_tpu_torch.encode_file

    def encode(self, data: bytes) -> bytes:
        c = self.call
        return self._encode_file(data, c["generation"], c["block_size"], verify=c["verify"],
                                 impl=c["impl"], pack=True, device=self.device)

    def rows(self, data: bytes) -> int:
        return max(1, -(-len(data) // self.call["block_size"]))

    def reference(self, data: bytes, depth: int | None = None) -> bytes:
        return ata2.build(data, self.call["generation"], self.call["block_size"], self.device, depth)
