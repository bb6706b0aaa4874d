"""The four collectives of the sharded megablock, with two backends.

The per-shard programs of ``parallel/megablock.py`` and ``megapipe.py`` are
written once against ``ppermute``, ``all_gather``, ``psum`` and
``axis_index`` (the ``jax.lax`` names), and ``ppermute_view``: the
``ppermute`` result as (tensor, source rows), for a consumer that reads the
rows where they lie.  Every per-shard tensor carries a leading axis over the
shards that THIS process holds, so the same program text serves both
backends:

- ``InProcess``: all ``ns`` shards are the rows of an ``(ns, ...)`` tensor on
  one device.  ``ppermute`` is a reordering of the rows, ``axis_index`` a
  column ``arange(ns)``, ``all_gather`` a broadcast view, ``psum`` a sum over
  the rows, ``ppermute_view`` the tensor itself with the row map.  Taken whenever every device of the mesh is the same one: that
  is how the CPU runs 8 shards and how one GPU runs an 8-shard megablock,
  every local sort one ``sort_rows`` call for all shards.
- ``Distributed``: one rank of a ``torch.distributed`` group a shard, the
  leading axis of length 1.  ``ppermute`` is one ``batch_isend_irecv``,
  ``all_gather`` and ``psum`` the group's ``all_gather`` and ``all_reduce``
  (gloo on CPU tensors, NCCL on CUDA tensors).

``collectives(mesh, axis)`` picks the backend from the mesh; ``spawn`` starts
one process a rank on this host and returns rank 0's result.
"""

from __future__ import annotations

import socket

import torch


def _sources(perm, ns: int) -> list[int]:
    """``src[d]`` for a ``ppermute`` spec of (source, destination) pairs that
    is a permutation of the ``ns`` shards (every spec of the megablock is)."""
    src = [-1] * ns
    for s, d in perm:
        src[d] = s
    if sorted(src) != list(range(ns)):
        raise ValueError(f"ppermute spec is not a permutation of {ns} shards: {perm}")
    return src


class InProcess:
    """All ``ns`` shards as the rows of one tensor on ``device``."""

    def __init__(self, ns: int, device):
        self.ns = ns
        self.device = torch.device(device)

    def axis_index(self) -> torch.Tensor:
        """Shard ids of the rows held here: an (rows, 1) int32 column."""
        return torch.arange(self.ns, dtype=torch.int32, device=self.device)[:, None]

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Row ``d`` of the result is row ``s`` of ``x`` for (s, d) in ``perm``."""
        src = _sources(perm, self.ns)
        if src == list(range(self.ns)):
            return x
        # a stack of row views, not an index tensor: making one from a Python
        # list is a blocking copy to the device, which would stall the host
        # behind everything enqueued so far, once a ppermute
        return torch.stack([x[s] for s in src])

    def ppermute_view(self, x: torch.Tensor, perm) -> tuple[torch.Tensor, list[int]]:
        """``ppermute(x, perm)`` where the rows already lie: ``(x, src)``, row
        ``d`` of the result being row ``src[d]`` of ``x``; nothing is copied."""
        return x, _sources(perm, self.ns)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` on every shard: (rows, ns, ...) for an ``x``
        of (rows, ...), as a broadcast view."""
        return x.unsqueeze(0).expand(self.ns, *x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over all shards, without the shard axis."""
        return x.sum(0, dtype=x.dtype)

    def shard(self, flat: torch.Tensor) -> torch.Tensor:
        """The shards held here of a global 1-D tensor: (rows, S) on ``device``."""
        return flat.to(self.device).view(self.ns, -1)


class Distributed:
    """One rank of ``group`` a shard; this process holds shard ``rank``."""

    def __init__(self, group, device):
        import torch.distributed as dist

        self.group = group
        self.ns = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)

    def axis_index(self) -> torch.Tensor:
        return torch.full((1, 1), self.rank, dtype=torch.int32, device=self.device)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        import torch.distributed as dist

        src = _sources(perm, self.ns)
        source, dest = src[self.rank], src.index(self.rank)
        if source == self.rank:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        ranks = dist.get_process_group_ranks(self.group)
        ops = [dist.P2POp(dist.isend, x, ranks[dest], self.group),
               dist.P2POp(dist.irecv, out, ranks[source], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def ppermute_view(self, x: torch.Tensor, perm) -> tuple[torch.Tensor, list[int]]:
        """``ppermute(x, perm)`` as ``(tensor, rows)``: the received tensor, whose
        one row is the result's."""
        return self.ppermute(x, perm), [0]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.ns)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, 0).unsqueeze(0)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        total = x.sum(0, dtype=x.dtype)
        dist.all_reduce(total, group=self.group)
        return total

    def shard(self, flat: torch.Tensor) -> torch.Tensor:
        S = flat.shape[0] // self.ns
        return flat[self.rank * S : (self.rank + 1) * S].to(self.device).view(1, S)


def collectives(mesh, axis: str):
    """The backend for ``mesh``'s axis ``axis``: ``Distributed`` when the mesh
    was made with a process group (one rank a device), ``InProcess`` when
    every device of the mesh is the same one."""
    ns = mesh.shape[axis]
    if ns != mesh.size:
        raise ValueError(f"the mesh must have the one axis {axis!r}, not {mesh.axes}")
    if mesh.group is not None:
        import torch.distributed as dist

        if dist.get_world_size(mesh.group) != ns:
            raise ValueError(f"the mesh has {ns} devices but its process group "
                             f"{dist.get_world_size(mesh.group)} ranks")
        return Distributed(mesh.group, mesh.devices[dist.get_rank(mesh.group)])
    if len(set(mesh.devices)) != 1:
        raise ValueError(
            f"a mesh over {len(set(mesh.devices))} distinct devices runs under torch.distributed, "
            "one rank a device: make it with make_mesh(..., group=...) inside each rank "
            "(parallel.collectives.spawn starts the ranks)")
    return InProcess(ns, mesh.devices[0])


def _rank_main(rank: int, world: int, backend: str, port: int, fn, args, result_path: str):
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        out = fn(rank, world, *args)
        if rank == 0:
            torch.save(out, result_path)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str, *args):
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes on this
    host, joined in one ``torch.distributed`` group of ``backend`` (``gloo``
    or ``nccl``; with ``nccl`` rank r takes card r), and return what rank 0
    returned.  ``fn`` must be importable (a module-level function) and its
    result something ``torch.save`` writes."""
    import tempfile

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/rank0.pt"
        mp.start_processes(_rank_main, args=(world, backend, port, fn, args, path), nprocs=world,
                           join=True, start_method="spawn")
        return torch.load(path, weights_only=False)
