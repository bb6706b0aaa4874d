"""Adapter for ``archon_tpu_torch.parallel.megapipe.encode_megablock``: one
input sorted as ONE block over the shards of an 'sp' mesh, in the ATM1
container.

The configuration's ``call`` holds generation, coder and shards; every shard
lies on the one device the run is given (``shard_devices`` 1: shards in
process, the rows of one tensor).  A request is one input; its row is the
whole megablock.
"""

from __future__ import annotations

from portbench.reference import atm1

SPANS = (
    "archon_tpu_torch.parallel.megablock:_sharded_ranks",
    "archon_tpu_torch.parallel.megablock:_merge_split_sort",
    "archon_tpu_torch.parallel.megapipe:pack_codes_sized",
)


class Adapter:
    diff = staticmethod(atm1.diff)
    summary = staticmethod(atm1.summary)

    def __init__(self, call: dict, device):
        from archon_tpu_torch.parallel.blocks import make_mesh
        from archon_tpu_torch.parallel.megapipe import encode_megablock

        if call["shard_devices"] != 1:
            raise ValueError("the harness lays every shard on the one device it is given")
        self.call = call
        self.device = device
        self._encode = encode_megablock
        self._mesh = make_mesh({"sp": call["shards"]}, devices=[device] * call["shards"])

    def encode(self, data: bytes) -> bytes:
        return self._encode(data, self._mesh, self.call["generation"], self.call["coder"])

    def rows(self, data: bytes) -> int:
        return 1

    def reference(self, data: bytes, depth: int | None = None) -> bytes:
        c = self.call
        return atm1.build(data, c["generation"], c["shards"], c["coder"], self.device, depth)
