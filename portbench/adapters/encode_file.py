"""Adapter for ``archon_tpu_torch.encode_file``: the blocked ATA1 container.

The configuration's ``call`` holds the arguments: generation, block_size,
verify, impl and pack.  A request is one file; its rows are its blocks.
"""

from __future__ import annotations

from portbench.reference import ata1

# layer functions the traced run opens a span around (module:function)
SPANS = (
    "archon_tpu_torch.io.blocks:_batched_forward",
    "archon_tpu_torch.io.blocks:_reversed_on",
    "archon_tpu_torch.parallel.blocks:bwt_blocks_micro_certified",
    "archon_tpu_torch.parallel.blocks:bwt_blocks_micro",
)  # not io.blocks:_fallback_row: it counts its calls on itself (see trace.wrap)


class Adapter:
    diff = staticmethod(ata1.diff)
    summary = staticmethod(ata1.summary)

    def __init__(self, call: dict, device):
        import archon_tpu_torch

        if call["pack"]:
            raise ValueError("the reference writes ATA1 only; pack must be false")
        self.call = call
        self.device = device
        self._encode_file = archon_tpu_torch.encode_file

    def encode(self, data: bytes) -> bytes:
        c = self.call
        return self._encode_file(data, c["generation"], c["block_size"], verify=c["verify"],
                                 impl=c["impl"], pack=False, device=self.device)

    def rows(self, data: bytes) -> int:
        return max(1, -(-len(data) // self.call["block_size"]))

    def reference(self, data: bytes, depth: int | None = None) -> bytes:
        return ata1.build(data, self.call["generation"], self.call["block_size"], self.device, depth)
