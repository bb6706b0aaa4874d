"""Sharded-megablock suffix sort: distributed prefix doubling over a mesh
(port of ``archon_tpu/parallel/megablock.py``; names and structure kept).

For inputs sorted as ONE block across shards, the text shards across the
``sp`` mesh axis and each doubling round runs as a distributed sort.  Per
round (context k, quadrupling: the tuple (r@0, r@k, r@2k, r@3k) covers 4k):

1. shifted ranks r@jk arrive by a bounded halo: the window
   ``rank[pos + j*k : pos + j*k + S]`` is two slices of two ring neighbours
   at distance ``(j*k)//S``, exactly S values per window by ``ppermute``;
2. tuples (r0, r1, r2, r3, pos), where ``pos`` makes the key total, are
   sorted globally by a bitonic merge-split network over shards: a local
   sort, then log2(ns)*(log2(ns)+1)/2 ppermute+merge stages.  The result is
   the exact global order with exactly S tuples per shard, whatever the tie
   groups (all-zeros input spans every shard);
3. head flags compare neighbour tuples (the boundary tuple by ppermute); the
   group-head slot crosses any number of headless shards by an all_gather of
   ns per-shard scalars and a running max;
4. (pos, new_rank) pairs return to the shards that own ``pos`` by a second,
   2-wide merge-split network.

The per-shard programs are written once against the four collectives of
``parallel/collectives.py``; every per-shard tensor has a leading axis over
the shards held by this process ((ns, S) in process, (1, S) for one rank of
a ``torch.distributed`` group).  Every sort is ``ops.sort.sort_rows`` or
``merge_rows`` along that layout, so on CUDA tensors each is K1 and K2
launches for all shards at once, and on CPU tensors their plain twins.

Differences from the JAX program, none of which changes a value:

- a merge-split stage sorts ``[mine, partner]``, two runs that are already
  sorted, so at every shard size the stage is ONE merge level
  (``merge_rows``) instead of a full re-sort;
- nothing is compiled per k, so ``_rotate_dyn`` is one ``ppermute`` at the
  distance asked for, and the ``_make_*`` functions return plain closures,
  not cached programs;
- no round runs past resolution (below);
- the emit's previous-byte payload stays uint8.

Termination: the JAX loop runs dispatch-ahead (round k is enqueued before
round k/4's surviving-tie count is read, at the price of one speculative
round); this one reads the count first and wastes no round, see
``_sharded_ranks``.  ``stats`` counts rounds and host reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.doubling import SENT_SMALL
from ..ops.scan import blocked_cummax
from ..ops.sort import merge_rows, sort_rows
from ..utils.timing import span
from .blocks import Mesh
from .collectives import collectives

AXIS = "sp"
_I32 = torch.int32


class _Counter:
    """Rounds run (the init not counted) and counts read back to the host
    since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.rounds = 0
        self.host_syncs = 0


stats = _Counter()


def _pairs(ns: int, m: int):
    """ppermute spec exchanging with the partner at xor-distance m."""
    return [(i, i ^ m) for i in range(ns)]


def _rot(ns: int, d: int):
    """ppermute spec: receiver i gets data from shard (i + d) % ns."""
    return [(s, (s - d) % ns) for s in range(ns)]


def _bitonic_stages(ns: int):
    """(k_bit, m) per merge-split stage of Batcher's bitonic network."""
    stages = []
    size = 2
    while size <= ns:
        m = size // 2
        while m >= 1:
            stages.append((size, m))
            m //= 2
        size *= 2
    return stages


def _stage_merge(both, num_keys: int):
    """A merge-split stage as what it is: both halves of ``[mine, partner]``
    are sorted, so one merge level gives the sorted row."""
    return merge_rows(both[:num_keys], both[num_keys:])


def _merge_split_sort(arrays, num_keys: int, ns: int, sid, coll):
    """Globally sort shard-distributed arrays by the first num_keys operands.

    Each shard's slice is sorted locally, then Batcher's bitonic network runs
    over shards with merge-split comparators.  Keys must be totally ordering
    (include a unique tie-break operand among the keys).  Returns arrays in
    global sorted order: shard i holds global slots [i*S, (i+1)*S).
    """
    with span("archon.megablock.local_sort"):
        arrays = sort_rows(arrays[:num_keys], arrays[num_keys:])
    S = arrays[0].shape[1]
    for k_bit, m in _bitonic_stages(ns):
        with span("archon.megablock.stage"):
            perm = _pairs(ns, m)
            partner = [coll.ppermute(a, perm) for a in arrays]
            both = [torch.cat([a, b], dim=1) for a, b in zip(arrays, partner)]
            del partner
            merged = _stage_merge(both, num_keys)
            del both
            # min half goes to the lower shard of the pair in an ascending
            # region ((sid & k_bit) == 0), to the higher shard otherwise
            keep_low = ((sid & m) == 0) == ((sid & k_bit) == 0)
            arrays = [torch.where(keep_low, mg[:, :S], mg[:, S:]) for mg in merged]
    return arrays


def _halo_window(rank_shard, jk: int, S: int, ns: int, coll):
    """Global rank[sid*S + jk : sid*S + jk + S] via at most two ppermutes.

    Values at global positions >= n are garbage; the caller masks them.
    """
    d, o = divmod(jk, S)
    d %= ns  # ring arithmetic; off-end positions are masked by the caller

    def fetch(x, dist):  # distance-0 needs no wire
        return x if dist == 0 else coll.ppermute(x, _rot(ns, dist))

    if o == 0:
        return fetch(rank_shard, d)
    a = fetch(rank_shard[:, o:], d)
    b = fetch(rank_shard[:, :o], (d + 1) % ns)
    return torch.cat([a, b], dim=1)


def _slot_ranks(keys, pos, S: int, ns: int, n: int, sid, coll):
    """Shared back half of init and rounds: global sort of (keys..., pos),
    head flags, group-head slot ranks with cross-shard propagation, active
    count, and the merge-split route-back to pos order.

    Returns (new_rank_shard, nactive)."""
    width = len(keys)
    srt = _merge_split_sort(list(keys) + [pos], width + 1, ns, sid, coll)
    keys_s, pos_s = srt[:width], srt[width]
    del srt
    iota = torch.arange(S, dtype=_I32, device=pos.device)
    g_slot = sid * S + iota

    # head flags: tuple differs from predecessor (previous shard's last
    # tuple crosses by ppermute; shard 0 slot 0 is always a head)
    last = torch.stack([k[:, -1] for k in keys_s], dim=1)
    prev = coll.ppermute(last, _rot(ns, -1))
    head = torch.zeros(g_slot.shape, dtype=torch.bool, device=pos.device)
    for j, k in enumerate(keys_s):
        head[:, 1:] |= k[:, 1:] != k[:, :-1]
        head[:, 0] |= k[:, 0] != prev[:, j]
    del keys_s
    head[:, 0] |= sid[:, 0] == 0

    # rank := slot of the group head.  local cummax, then an exact carry:
    # every shard's last head-slot is all_gathered (ns scalars) and the
    # running max over preceding shards propagates across any number of
    # headless shards in one step.
    local_head = blocked_cummax(torch.where(head, g_slot, -1))
    lasts = coll.all_gather(local_head[:, -1])
    before = torch.arange(ns, dtype=_I32, device=pos.device)[None, :] < sid
    carry = torch.where(before, lasts, -1).max(dim=1).values
    new_rank_s = torch.maximum(local_head, carry[:, None])

    # surviving ties: group size > 1  <=>  not (head & next-is-head).
    # the successor of the shard's last slot lives on the next shard.
    nbr_first = coll.ppermute(head[:, :1], _rot(ns, 1))
    nxt_head = torch.cat([head[:, 1:], nbr_first], dim=1)
    nxt_head[:, -1] |= sid[:, 0] == ns - 1
    active = ~(head & nxt_head)
    nactive = coll.psum(active.sum(dim=1, dtype=_I32))

    # route back: (pos_s, rank) is a permutation of [0, n); the 2-wide
    # merge-split network lands pos range [i*S, (i+1)*S) on shard i sorted,
    # so the values column is the pos-ordered rank shard
    _, rank_back = _merge_split_sort([pos_s, new_rank_s], 1, ns, sid, coll)
    return rank_back, nactive


def _positions(S: int, sid) -> torch.Tensor:
    """Global positions of the shards held here: ``sid * S + iota``, int32."""
    return sid * S + torch.arange(S, dtype=_I32, device=sid.device)


def _make_init(mesh: Mesh, S: int, n: int, sentinel: str):
    """Seed ranks: positional rank of the packed order-3 key at each pos.

    The 2-symbol halo comes from the ring neighbour; ranking runs through the
    shared merge-split machinery (no global-array op anywhere).
    """
    coll = collectives(mesh, AXIS)
    ns = coll.ns
    pad_val = 0 if sentinel == SENT_SMALL else 511

    def init_fn(data_shard):
        sid = coll.axis_index()
        ext = data_shard.to(_I32) + 1
        halo = coll.ppermute(ext[:, :2], _rot(ns, 1))
        halo = torch.where(sid == ns - 1, pad_val, halo)
        extp = torch.cat([ext, halo], dim=1)
        packed = extp[:, :S] * (512 * 512) + extp[:, 1 : S + 1] * 512 + extp[:, 2 : S + 2]
        return _slot_ranks((packed,), _positions(S, sid), S, ns, n, sid, coll)

    return init_fn


def _make_round(mesh: Mesh, S: int, n: int, k: int, sentinel: str):
    """One distributed quadrupling round at fixed context k (kept for
    comparison and tests; ``_sharded_ranks`` uses ``_make_round_dyn``)."""
    coll = collectives(mesh, AXIS)
    ns = coll.ns
    off_end = -1 if sentinel == SENT_SMALL else n + 1

    def round_fn(rank_shard):
        sid = coll.axis_index()
        pos = _positions(S, sid)

        def shifted(j):
            if j * k >= n:  # whole window off-end
                return torch.full_like(rank_shard, off_end)
            w = _halo_window(rank_shard, j * k, S, ns, coll)
            return torch.where(pos + j * k < n, w, off_end)

        keys = (rank_shard, shifted(1), shifted(2), shifted(3))
        return _slot_ranks(keys, pos, S, ns, n, sid, coll)

    return round_fn


def _rotate_dyn(x, d: int, ns: int, coll):
    """Ring-rotate a shard array by a distance d in [0, ns) that is known
    only when the round runs: shard i ends up holding shard (i+d) % ns's x.
    The JAX program composes log2(ns) static ppermutes selected by d's bits,
    to compile one round program for every k; nothing is compiled here, so it
    is the one ppermute at distance d."""
    return x if d == 0 else coll.ppermute(x, _rot(ns, d))


def _halo_window_dyn(rank_shard, jk: int, S: int, ns: int, coll):
    """Global rank[sid*S + jk : sid*S + jk + S] for a jk given at run time.

    Values at global positions >= n are garbage; the caller masks them."""
    d = (jk // S) % ns
    o = jk % S
    rot_d = _rotate_dyn(rank_shard, d, ns, coll)
    rot_d1 = coll.ppermute(rot_d, _rot(ns, 1))
    return torch.cat([rot_d, rot_d1], dim=1)[:, o : o + S]


def _make_round_dyn(mesh: Mesh, S: int, n: int, sentinel: str):
    """The k-dynamic distributed quadrupling round: one function for every
    context k, which it takes as an int."""
    coll = collectives(mesh, AXIS)
    ns = coll.ns
    off_end = -1 if sentinel == SENT_SMALL else n + 1

    def round_fn(rank_shard, k: int):
        sid = coll.axis_index()
        pos = _positions(S, sid)

        def shifted(j):
            jk = j * int(k)
            if jk >= n:  # whole window off-end: the mask below would be all false
                return torch.full_like(rank_shard, off_end)
            w = _halo_window_dyn(rank_shard, jk, S, ns, coll)
            return torch.where(pos + jk < n, w, off_end)

        keys = (rank_shard, shifted(1), shifted(2), shifted(3))
        return _slot_ranks(keys, pos, S, ns, n, sid, coll)

    return round_fn


def _make_emit(mesh: Mesh, S: int, n: int):
    """Sharded BWT emission: L[rank[p]] = data[(p-1) mod n], via one more
    merge-split sort keyed on rank with the prev-byte payload riding along,
    the sharded analog of the carried-payload emission in core/batched.
    Shard i returns L[i*S:(i+1)*S]; base = rank[0] comes back replicated."""
    coll = collectives(mesh, AXIS)
    ns = coll.ns

    def emit_fn(rank_shard, data_shard):
        sid = coll.axis_index()
        pos = _positions(S, sid)
        last = coll.ppermute(data_shard[:, -1:], _rot(ns, -1))
        prev = torch.cat([last, data_shard[:, :-1]], dim=1)
        _, L_shard = _merge_split_sort([rank_shard, prev], 1, ns, sid, coll)
        base = coll.psum(torch.where(pos == 0, rank_shard, 0).sum(dim=1, dtype=_I32))
        return L_shard, base

    return emit_fn


def _sharded_ranks(data, mesh: Mesh, sentinel: str):
    """Shared loop: distributed doubling to full rank resolution.
    Returns (rank_shards, data_shards, S, n): the (rows, S) tensors of the
    shards this process holds."""
    arr = np.array(data, np.uint8)  # a writable, contiguous copy
    n = len(arr)
    ns = mesh.shape[AXIS]
    if n % ns:
        raise ValueError(f"n={n} not divisible by {ns} shards")
    if ns & (ns - 1):
        raise ValueError(f"shard count {ns} must be a power of two")
    S = n // ns

    coll = collectives(mesh, AXIS)

    def resolved(na, k: int) -> bool:
        """No round is left: context k covers the text, or the surviving-tie
        count reads 0 (one host read)."""
        if k >= 4 * n:
            return True
        stats.host_syncs += 1
        return int(na) == 0

    # the JAX loop enqueues round k before it reads round k/4's surviving-tie
    # count, to hide the read behind device work, and so always runs one round
    # past resolution.  Here a round takes the host a few ms to enqueue and the
    # card tens to hundreds to run, so the read comes first: the card idles
    # for one enqueue a round and no round is wasted.  The ranks returned are
    # those of the round whose count was 0 either way.
    k = 3
    with span("archon.megablock.init"):
        data_dev = coll.shard(torch.from_numpy(arr))
        prev_rank, prev_na = _make_init(mesh, S, n, sentinel)(data_dev)
        done = resolved(prev_na, k)
    round_fn = _make_round_dyn(mesh, S, n, sentinel)
    while not done:
        with span("archon.megablock.round"):
            prev_rank, prev_na = round_fn(prev_rank, k)
            stats.rounds += 1
            k *= 4
            done = resolved(prev_na, k)
    return prev_rank, data_dev, S, n


def bwt_megablock(data, mesh: Mesh, sentinel: str = SENT_SMALL):
    """Sharded forward BWT of one megablock: returns (L_shards, base) with L
    still on the device and sharded over 'sp': a (rows, S) uint8 tensor of
    the shards this process holds (all of them, in order, on an in-process
    mesh: ``L_shards.reshape(-1)`` is L), ready for the sharded entropy stage
    (parallel.megapipe)."""
    rank, data_dev, S, n = _sharded_ranks(data, mesh, sentinel)
    with span("archon.megablock.emit"):
        L, base = _make_emit(mesh, S, n)(rank, data_dev)
        return L, int(base)


def suffix_array_sharded(data, mesh: Mesh, sentinel: str = SENT_SMALL) -> np.ndarray:
    """Distributed suffix array over mesh axis 'sp'.

    Exact for every input (incl. shard-spanning tie groups: all-zeros,
    Fibonacci strings, the Gauntlet pathologies).  ``n`` must divide evenly by
    the shard count (the megablock container pads); the shard count must be a
    power of two.
    """
    prev_rank, _data_dev, S, n = _sharded_ranks(data, mesh, sentinel)
    coll = collectives(mesh, AXIS)
    r = coll.all_gather(prev_rank)[0].reshape(-1).cpu().numpy()
    if np.unique(r).size != n:  # pragma: no cover - permutation invariant
        raise AssertionError("megablock ranks did not resolve to a permutation")
    sa = np.zeros(n, np.int32)
    sa[r] = np.arange(n, dtype=np.int32)
    return sa


def _rank_mesh(world: int, device_type: str) -> Mesh:
    """The 'sp' mesh of the initialized default ``torch.distributed`` group of
    ``world`` ranks, one shard a rank: every rank on the CPU for
    ``device_type`` "cpu", rank r on card r for "cuda"."""
    import torch.distributed as dist

    from .blocks import make_mesh

    devices = [torch.device(device_type, r) if device_type == "cuda" else torch.device("cpu")
               for r in range(world)]
    return make_mesh({AXIS: world}, devices=devices, group=dist.group.WORLD)


def _suffix_array_on_rank(rank: int, world: int, data, device_type: str, sentinel: str) -> np.ndarray:
    """``suffix_array_sharded`` as rank ``rank`` of ``world`` (the entry that
    ``collectives.spawn`` runs): every rank returns the whole array."""
    return suffix_array_sharded(data, _rank_mesh(world, device_type), sentinel)
