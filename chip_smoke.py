#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (archon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printing its own lines; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``archon_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin on the card, exact equality, at
   the shapes the forward BWT, a6 and the inverse give it (among them 1 key +
   index at 2^24, 49 keys through K2 levels, the a6 bit path's 4 window keys
   + index at the bit width of a 1 MiB ``fix`` input, and the real sorts of
   one 4 MiB text block: the bootstrap's trigram keys and the full round's
   rank keys, and the sorts the IT-2 and SA-IS paths run on that block: 5
   keys + index with 2 payloads at 2^22, 2 keys + index at 2^23 + 2, 1 key +
   1 payload at 2^21); timed (K1, all K2 levels of one sort, the whole
   ``sort_operands``, each beside its plain twin) at 2^22 x 6 operands with
   random keys, at the text block's real sorts, and at 1 key + index at
   2^24;
4. the main path through ``archon_tpu_torch.encode_file``: 64 MiB of
   synthetic text in 4 MiB blocks (a4), verify on and off, and 16 MiB (a7),
   each decoded back with ``decode_file``, block 0 held against a plain numpy
   BWT (prefix doubling, below); one 1 MiB planted-repeat block through the
   micro tail and the narrowed cascade.  Kernel launch counts are zeroed just
   before the 64 MiB verify-on run and read just after it;
5. a6 on 16 MiB of the text: ``a6_encode``/``a6_decode`` with each coder on
   the card (encode and decode MB/s), the ``byte`` blob of 4 MiB against the
   a7 reference BWT, the bit path against the symbol path on 1 MiB, a
   single-symbol ``var`` input and a ``-o freq`` round trip at 4 MiB;
6. the device inverse: ``formats.decode(..., device="cuda")`` of a 16 MiB a4
   and a7 block against the input and the host walk, n = 5000 and n = 1, and
   its time split into ``lf_successor`` and ``pointer_walk`` (CUDA events)
   beside the host walk's;
7. where a block's time goes: ``bwt_v3`` on one 4 MiB text block (CUDA
   events), the host LF walk of one block (``decode_file``), and
   ``torch.profiler``'s self device time per op over one ``bwt_v3``, with the
   device busy share of that call;
8. ``sort_rows`` (the batched sort, rows end to end through the same two
   kernels) against its plain twin at the batched path's shapes, timed at
   (8, 2^22);
9. the batched container path: the same 64 MiB through ``impl="micro"``
   (verify on and off) and 16 MiB through ``impl="v3"``, each byte-identical
   with the stream's container, MB/s beside the stream's and by rows per
   unit; one unit of 8 rows apart (ms, rounds, host syncs, launches, peak memory, the certificate's
   ms); a corrupted L failing the certificate; a file with a row that the
   micro program cannot resolve, through ``_fallback_row``;
9b. the ATA2 pack on the card (``ops.pack``): ``mtf_rle`` and ``pack_words``
    against their twins on a 4 MiB text BWT row, timed on an (8, 4 MiB) unit
    (each of the six kernels by ``torch.profiler`` beside its byte bound),
    and ``entropy.pack.RowPack``'s payloads of the unit equal to
    ``pack_block``'s; then 40 MiB (a unit of 8 rows and a tail of 2) through
    ``encode_file(pack=True)`` equal to the host pack's container, with the
    pack kernels' launches counted from zero in that run alone;
10. resume: ``encode_to_path`` cut in the middle of a frame and resumed, then
    resumed after one input byte changed; ``extract_block`` of both
    containers;
11. the v1 sorters on one 4 MiB text block and two planted-repeat blocks
    (``suffix_array``, ``suffix_array_fast``, ``bwt_forward``,
    ``bwt_forward_fast``, and ``bwt_forward_batched`` on 4 rows of 1 MiB):
    every shape of sort they give the kernels (full width, and the narrowed
    rounds and compactions at n/4 and n/32 with their pads) held to its plain
    twin first, then the results equal to ``bwt_v3``, the suffix array
    certified by ``verify_sa``; ms, rounds, host syncs, launches;
12. ``bwt_sais`` on the text block, a4 and a7, equal to ``bwt_v3`` (timed
    over one call after the counted one, as ``bwt_it2`` and its stages are);
13. ``bwt_it2`` on the text block, a4 and a7 (``ok``, equal to ``bwt_v3``, its
    three stages timed apart), the a4 64 MiB encode with ``impl="it2"``
    (verify on and off) byte-identical with the stream's, its blocks that
    fell back to ``bwt_v3`` counted, and Gauntlet blocks through
    ``impl="it2"`` (flagged or exact, the stream's container either way);
14. the sharded megablock (``parallel/megablock``, ``parallel/megapipe``) as
    8 shards in process on the one card: every shape of sort it launches on
    a 4 MiB text block (``sort_rows`` at (8, S) and the merge-split stages'
    ``stage_merge`` of (8, S) rows and their partners; 5, 2 and 1 keys) held
    to its twins (K1, every K2 level, the whole sort; a stage as one
    ``stage_merge`` call, no K1 or K2 launch, against ``stage_merge_ref`` and
    against the same stage as one K2 merge level, ``merge_rows``) and timed
    beside the stable ``torch.sort`` chain; the stages of a 10^6-byte
    megablock (S = 125,000, each row's last tile masked) held alike;
    ``bwt_megablock`` of the 4 MiB block equal to ``bwt_v3`` and timed beside
    the same with every stage as one K2 level, and of 2^20 zeros
    and fibonacci; then 64 MiB as ONE megablock: init, each round, emit,
    hist and pack timed apart (device ms by CUDA events, and the host's
    enqueue ms), the whole ``encode_megablock`` with its launches, rounds,
    host reads and peak memory, ``decode_megablock`` back to the input, the
    ``ATM1`` size beside the ATA2 container's, and its sort shapes held to
    their twins;
15. ``unbwt_blocks`` on (8, 4 MiB), all rows in one lockstep walk, against
    the row loop; ``formats.encode`` with the device certificate on and off;
16. the command line in subprocesses: ``e --impl it2 --profile-dir`` on a
    16 MiB file (stage report, a trace file), ``d`` back to the input; then
    ``e --sp 8`` (an ``ATM1`` file) and ``d`` of it;
17. ``utils.tools.memory_report`` beside the measured peak of ``bwt_v3``;
18. one JSON line describing the kernels (the six pack kernels with the
    launches of phase 9b's ``encode_file``), then the device line last.

Phases 5 and 6 zero the kernel launch counts before each encode or device
decode and fail unless both kernels launched in it; so do the 64 MiB runs of
the stream, the batched path and ``impl="it2"``, whose counts the JSON line
reports, every call of phases 11 to 13, and the 64 MiB megablock of phase 14.

The script uses the port's own API only; its test data and its BWT
reference are made here, from fixed seeds.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MIB = 1 << 20
TIMED_CALLS = 5
SOURCE = "archon_tpu_torch/csrc/sort.cu"
PACK_SOURCE = "archon_tpu_torch/csrc/pack.cu"
# the kernels of each ops.pack call, in launch order
PACK_CALLS = {"mtf_rle": ("pack_occ_kernel", "pack_occ_scan_kernel", "pack_mtf_kernel",
                          "pack_rle_scan_kernel"),
              "pack_words": ("pack_bits_scan_kernel", "pack_words_kernel")}
REPLACES = {
    "sort_tiles": "archon_tpu/ops/pallas_sort.py:393",
    "merge_level": "archon_tpu/ops/pallas_sort.py:317",
}


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false -- no GPU, no result")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from archon_tpu_torch.io.blocks import host_walk
    from archon_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    print(f"[build] CUDA kernels ready in {time.perf_counter() - t0:.2f} s")
    for name, regs, stores, loads in _build.kernel_resources(_build.BUILD_LOG):
        print(f"[build] {name}: {regs} registers, spill stores {stores} B, loads {loads} B")
    t0 = time.perf_counter()
    walk = host_walk()
    print(f"[build] host LF walk: {walk}, ready in {time.perf_counter() - t0:.2f} s")
    if walk != "native":
        raise RuntimeError("the native host LF walk did not build: verify would measure numpy")


def _events_ms(fn, calls=TIMED_CALLS):
    """Mean milliseconds of ``fn`` over ``calls`` calls, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def _timed(fn, calls=TIMED_CALLS):
    """``fn``'s result from one warm-up call, and its mean milliseconds over
    ``calls`` calls after it."""
    out = fn()
    return out, _events_ms(fn, calls)


def _time_ms(fn):
    """Mean milliseconds of ``fn`` over ``TIMED_CALLS`` calls after one
    warm-up call."""
    return _timed(fn)[1]


def _max_err(got, want) -> int:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


KERNEL_ERR = {"sort_tiles": 0, "merge_level": 0, "stage_merge": 0}  # largest error against a twin


def check_sort(name, keys, payloads, tag="kernels"):
    """K1, every K2 level and the whole ``sort_operands`` on these operands
    against their plain twins; raises unless all are equal."""
    import torch

    from archon_tpu_torch.ops import sort as S

    err = KERNEL_ERR
    keys = [k.contiguous() for k in keys]
    mat = torch.stack(keys)
    tuples = S.sort_tiles(mat)
    e1 = _max_err(tuples, S.sort_tiles_ref(mat))
    run, e2 = S.TILE, 0
    while run < tuples.shape[1]:
        nxt = S.merge_level(mat, tuples, run)
        e2 = max(e2, _max_err(nxt, S.merge_level_ref(mat, tuples, run)))
        tuples, run = nxt, run * 2
    got = S.sort_operands(keys, payloads)
    want = S.sort_operands_ref(keys, payloads)
    e3 = max(_max_err(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    err["sort_tiles"] = max(err["sort_tiles"], e1)
    err["merge_level"] = max(err["merge_level"], e2, e3)
    status = "ok" if e1 == e2 == e3 == 0 else "MISMATCH"
    print(f"[{tag}] {name}: n={keys[0].shape[0]} keys={len(keys)}+index "
          f"payloads={len(payloads)} tile_err={e1} merge_err={e2} sort_err={e3} {status}")
    if status != "ok":
        raise AssertionError(f"kernel disagrees with its plain twin: {name}")


def phase_kernels():
    """Every kernel against its twin on the card; returns per-kernel stats."""
    import numpy as np
    import torch

    from archon_tpu_torch.ops import sort as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    check = check_sort

    def keyset(n, count, hi):
        return [torch.from_numpy(rng.integers(-1, hi, n).astype(np.int32)).to(dev)
                for _ in range(count)]

    n = 1 << 22
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    prev = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
    main_keys = keyset(n, 4, n // 64)
    check("full round (4 ranks + index; iota, prev u8)", main_keys, [iota, prev])
    check("compaction (2 keys; 2 payloads) n/16", keyset(n // 16, 2, 3),
          keyset(n // 16, 2, 1 << 30))
    for count in (13, 49):
        check(f"micro round ({count} keys + index = {count + 1})", keyset(4096, count, 4),
              keyset(4096, 1, 4096))
    check("49 keys past 4 carried, through K2 levels", keyset(20_011, 49, 3), [])
    check("ragged n = 2^22 - 17", keyset(n - 17, 2, 1000), keyset(n - 17, 1, 1 << 30))
    check("n = 1", keyset(1, 3, 5), keyset(1, 1, 5))
    edge = keyset(100_003, 2, 3)
    for k in edge:
        k[k == 1] = 0x7FFFFFFF
    check("keys of -1 and 0x7FFFFFFF", edge, [])
    check("all-equal keys", [torch.zeros(300_001, dtype=torch.int32, device=dev)] * 2, [])
    big = 1 << 24  # a6 emission and lf_successor at 16 MiB: 1 byte key + index
    big_keys, big_pay = keyset(big, 1, 256), [torch.arange(big, device=dev)]
    check("1 key 0..255 + index, 2^24", big_keys, big_pay)
    win_keys = _bit_window_keys(synthetic_text(MIB, seed=7), dev)
    check("a6 bit bootstrap, 4 base-3 16-windows + index, 1 MiB fix", win_keys,
          [torch.arange(win_keys[0].shape[0], device=dev)])
    text_sorts = _text_block_sorts(synthetic_text(4 * MIB, seed=7))
    for label, (keys, payloads) in text_sorts.items():
        check(f"4 MiB text block, {label}", keys, payloads)
    new_sorts = _it2_sais_sorts(synthetic_text(4 * MIB, seed=7))
    for label, (keys, payloads) in new_sorts.items():
        check(f"4 MiB text block, {label}", keys, payloads)

    # timing: the full round's shape at random keys, the two real sorts of
    # one text block, and 1 key + index at 2^24
    rows = {"random keys (n/64 distinct), 2^22": (main_keys, [iota, prev]), **{
        f"text block {label}, 2^22": sorts for label, sorts in text_sorts.items()},
        "1 key 0..255 + index, 2^24": (big_keys, big_pay),
        **{f"text block {label}": sorts for label, sorts in new_sorts.items()}}
    times = {label: _time_sort(keys, payloads) for label, (keys, payloads) in rows.items()}
    for label, t in times.items():
        print(f"[timing] {label}, {t['keys']} keys + index, {t['payloads']} payloads: "
              f"sort_tiles {t['k1']:.3f} ms (plain {t['k1_plain']:.3f}); all {t['levels']} "
              f"merge levels {t['k2']:.3f} ms (plain {t['k2_plain']:.3f}); whole sort_operands "
              f"(stack, K1, {t['levels']} K2 levels, gathers) {t['sort']:.3f} ms "
              f"(plain torch.sort passes {t['sort_plain']:.3f})")
    t = times["random keys (n/64 distinct), 2^22"]
    print(f"[timing] random keys, 2^22: merge_level, last level only (run={t['last_run']} -> "
          f"{2 * t['last_run']}) {t['last']:.3f} ms (plain {t['last_plain']:.3f})")
    # bounds at the timed shape (2^22 x 4 keys + index; a K2 level moves 168 MB).
    # library_ms: no single PyTorch call sorts tiles or merges runs on four
    # keys; the chain of stable torch.sort passes for the whole sort is given
    # beside the whole hand sort instead
    bounds = kernel_bounds(n, 4, S.carried(4), S.TILE, n)
    whole = {"whole_sort_ms": t["sort"], "whole_sort_torch_ms": t["sort_plain"]}
    for name, b in bounds.items():
        print(f"[timing] {name} at 2^22 x 4 keys: bound {b['bound_ms']:.4f} ms by {b['bound_by']}")
    return {"sort_tiles": {"ms": t["k1"],
                           "plain_ms": t["k1_plain"], **bounds["sort_tiles"],
                           "library_ms": None, **whole},
            "merge_level": {"ms": t["last"],
                            "plain_ms": t["last_plain"], **bounds["merge_level"],
                            "library_ms": None, **whole}}


def _time_sort(keys, payloads) -> dict:
    """K1, all K2 levels, the last K2 level and the whole sort of ``keys``,
    each beside its plain twin (CUDA events)."""
    import torch

    from archon_tpu_torch.ops import sort as S

    mat = torch.stack(keys)
    first = S.sort_tiles(mat)

    def levels(merge, last=0):
        """K2 levels over K1's output, up to but not including the last
        ``last`` levels."""
        tuples, run = first, S.TILE
        while run << last < tuples.shape[1]:
            tuples, run = merge(mat, tuples, run), run * 2
        return tuples, run

    before_last, last_run = levels(S.merge_level, last=1)
    return {
        "keys": len(keys), "payloads": len(payloads),
        "levels": (first.shape[1] // S.TILE).bit_length() - 1, "last_run": last_run,
        "k1": _time_ms(lambda: S.sort_tiles(mat)), "k1_plain": _time_ms(lambda: S.sort_tiles_ref(mat)),
        "k2": _time_ms(lambda: levels(S.merge_level)),
        "k2_plain": _time_ms(lambda: levels(S.merge_level_ref)),
        "last": _time_ms(lambda: S.merge_level(mat, before_last, last_run)),
        "last_plain": _time_ms(lambda: S.merge_level_ref(mat, before_last, last_run)),
        "sort": _time_ms(lambda: S.sort_operands(keys, payloads)),
        "sort_plain": _time_ms(lambda: S.sort_operands_ref(keys, payloads)),
    }


def _text_block_sorts(block: bytes) -> dict:
    """The full-width sorts ``bwt_v3`` runs on one text block, as the main
    path gives them (the block reversed, a4): the bootstrap's four
    packed-trigram keys and each full round's four rank keys, with the index
    and the previous byte as payloads.  Captured at ``sort_rows`` as
    ``core.batched`` binds it, the one row of each operand."""
    from archon_tpu_torch.core import batched, fast2

    arr = _reversed_block(block)
    seen = []
    sort_rows = batched.sort_rows

    def capture(keys, payloads=()):
        if len(keys) == 4 and keys[0].shape[1] == arr.shape[0]:
            seen.append(([k[0] for k in keys], [p[0] for p in payloads]))
        return sort_rows(keys, payloads)

    batched.sort_rows = capture
    try:
        fast2.bwt_v3(arr, "small")
    finally:
        batched.sort_rows = sort_rows
    if len(seen) < 2:
        raise AssertionError(f"bwt_v3 ran {len(seen)} full-width sorts on a text block, not 2+")
    return {("bootstrap trigram keys" if i == 0 else f"full round {i} rank keys"): s
            for i, s in enumerate(seen)}


def _captured_sorts(modules, run, limit=None, attr="sort_operands") -> list:
    """The sorts that ``run()`` makes through the ``attr`` of ``modules``, as
    (keys, payloads) pairs: the first ``limit`` of them, or with no limit the
    first of each shape (key count, payload count, operand shape)."""
    real, seen, shapes = getattr(modules[0], attr), [], set()

    def capture(keys, payloads=()):
        shape = (len(keys), len(payloads), tuple(keys[0].shape))
        if len(seen) < limit if limit else shape not in shapes:
            shapes.add(shape)
            seen.append((list(keys), list(payloads)))
        return real(keys, payloads)

    for module in modules:
        setattr(module, attr, capture)
    try:
        run()
    finally:
        for module in modules:
            setattr(module, attr, real)
    return seen


def _it2_sais_sorts(block: bytes) -> dict:
    """The sorts that the IT-2 and SA-IS paths add, with the keys one text
    block gives them (the block reversed, a4): IT-2's naming sort (the lucky
    flag and four phrase keys; index and phrase length as payloads), its
    reduced-string sort (1 key, 1 payload, at M = 2^21 for 4 MiB) and its
    merge sort (four phrase keys and the reduced rank; index and previous
    byte), and SA-IS's first joint rank (2 keys + index at 2(n + 1))."""
    from archon_tpu_torch.core import it2, sais_tpu

    arr = _reversed_block(block)
    naming, reduced, merge = _captured_sorts((it2,), lambda: it2.bwt_it2(arr, "small"), 3)
    (joint,) = _captured_sorts((sais_tpu,), lambda: sais_tpu.suffix_ranks_sais(arr, "small"), 1)
    sorts = {"IT-2 naming sort": naming, "IT-2 reduced-string sort": reduced,
             "IT-2 merge sort": merge, "SA-IS joint rank": joint}
    shapes = {label: (len(k), len(pl), k[0].shape[0]) for label, (k, pl) in sorts.items()}
    n = len(block)
    if shapes != {"IT-2 naming sort": (5, 2, n), "IT-2 merge sort": (5, 2, n),
                  "IT-2 reduced-string sort": (1, 1, it2._reduced_capacity(n)),
                  "SA-IS joint rank": (2, 1, 2 * n + 2)}:
        raise AssertionError(f"the IT-2 and SA-IS sorts have other shapes than expected: {shapes}")
    return sorts


def _bit_window_keys(data: bytes, dev):
    """The four window keys the a6 bit path's bootstrap sorts for ``data``
    under ``fix``: the path runs once on the card and its windows are taken
    at ``suffix_ranks_windows``, then offset as ``_bootstrap_window_round``
    does (0, 16, 32, 48; off-end 0x7FFFFFFF)."""
    import numpy as np
    import torch

    from archon_tpu_torch.core import a6

    seen = []
    ranks = a6.suffix_ranks_windows

    def capture(win, w, sentinel):
        seen.append(win)
        return ranks(win, w, sentinel)

    a6.suffix_ranks_windows = capture
    try:
        a6.a6_forward(np.frombuffer(data, np.uint8), "fix", impl="bits", device=dev)
    finally:
        a6.suffix_ranks_windows = ranks
    (win,) = seen
    m = win.shape[0]
    winp = torch.cat([win, win.new_full((48,), 0x7FFFFFFF)])
    return [winp[16 * j : 16 * j + m] for j in range(4)]


_WORDS = (
    "a an the and or but if of to in on at by for with from as is are was be "
    "been it its this that these those we you they he she not no all any some "
    "one two three time year day way part place work word number people water "
    "block sort suffix rank context stream device kernel merge tile round key "
    "compress transform burrows wheeler archon text file byte order index"
).split()


def synthetic_text(n: int, seed: int) -> bytes:
    """Word-model text: Zipf-weighted words from a fixed vocabulary, with
    sentence breaks and line ends; made in bulk with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = [w.encode() + b" " for w in _WORDS] + [b". ", b",\n", b".\n\n"]
    p = 1.0 / np.arange(1, len(vocab) + 1) ** 1.05
    width = max(map(len, vocab))
    table = np.zeros((len(vocab), width), np.uint8)
    lens = np.array([len(v) for v in vocab])
    for i, v in enumerate(vocab):
        table[i, : len(v)] = np.frombuffer(v, np.uint8)
    picks = rng.choice(len(vocab), size=n // 3 + 1024, p=p / p.sum())
    mask = np.arange(width)[None, :] < lens[picks][:, None]
    out = table[picks][mask]
    while out.size < n:  # the pick count is an estimate; top up if short
        out = np.concatenate([out, out[: n - out.size]])
    return out[:n].tobytes()


@functools.lru_cache(maxsize=8)
def bwt_reference(block: bytes, generation: str):
    """(L, base) of the a4 (end-of-string smallest) or a7 (largest) BWT of
    the REVERSED block, the frame convention, by plain prefix doubling.  Kept
    per block: the phases hold many containers to the same first block."""
    import numpy as np

    s = np.frombuffer(block[::-1], np.uint8)
    n = len(s)
    end = -1 if generation == "a4" else n + 256
    rank, k = s.astype(np.int64), 1
    while True:
        nxt = np.full(n, end, np.int64)
        nxt[: max(n - k, 0)] = rank[k:]
        key = (rank + 1) * (n + 258) + (nxt + 1)
        sa = np.argsort(key, kind="stable")
        ks = key[sa]
        rank = np.empty(n, np.int64)
        rank[sa] = np.concatenate([[0], np.cumsum(ks[1:] != ks[:-1])])
        if rank.max() == n - 1:
            break
        k *= 2
    return s[(sa - 1) % n], int(np.flatnonzero(sa == 0)[0])


def _frame0(blob):
    """(L, base) of the first frame of an ATA1 container."""
    import numpy as np

    (n,) = struct.unpack("<I", blob[12:16])
    L = np.frombuffer(blob[16 : 16 + n], np.uint8)
    (base,) = struct.unpack("<I", blob[16 + n : 20 + n])
    return L, base


def _encode_checked(label, data, generation, block_size, verify=True, impl="stream", same_as=None):
    """One timed ``encode_file``; the container must decode back, its block 0
    equal the reference BWT and, where given, the whole equal ``same_as``.
    Returns (seconds, container)."""
    import numpy as np
    import torch

    import archon_tpu_torch as port

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = port.encode_file(data, generation, block_size, verify=verify, impl=impl, device="cuda")
    dt = time.perf_counter() - t0
    if same_as is not None and blob != same_as:
        raise AssertionError(f"{label}: container differs from the stream's")
    if port.decode_file(blob) != data:
        raise AssertionError(f"{label}: decode_file does not give the input back")
    L, base = _frame0(blob)
    want_L, want_base = bwt_reference(data[:block_size], generation)
    if not (np.array_equal(L, want_L) and base == want_base):
        raise AssertionError(f"{label}: block 0 differs from the reference BWT")
    print(f"[{ {'stream': 'main', 'it2': 'it2'}.get(impl, 'batched') }] {label}: {len(data)} bytes in {dt:.4f} s "
          f"= {len(data) / 1e6 / dt:.2f} MB/s (encode_file, impl {impl}, verify "
          f"{'on' if verify else 'off'}); round trip ok; block 0 == reference BWT"
          + ("; == stream container" if same_as is not None else ""))
    return dt, blob


def phase_main():
    """The port's stream path; returns the kernel launch counts of the 64 MiB
    run, the text, and the stream's containers and seconds by run."""
    from archon_tpu_torch.core import batched
    from archon_tpu_torch.ops import sort as S

    data = synthetic_text(64 * MIB, seed=7)
    print(f"[main] synthetic text, {len(data)} bytes")
    # untimed warm-up: the first call loads torch's CUDA modules for the ops
    _encode_checked("warm-up, a4 4 MiB (not a measurement)", data[: 4 * MIB], "a4", 4 * MIB)
    S.sort_tiles.launches = S.merge_level.launches = 0
    stream = {}
    stream["a4 on"] = _encode_checked("a4 64 MiB / 4 MiB blocks", data, "a4", 4 * MIB)
    launches = {"sort_tiles": S.sort_tiles.launches, "merge_level": S.merge_level.launches}
    print(f"[main] kernel launches in the a4 64 MiB run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    stream["a4 off"] = _encode_checked("a4 64 MiB / 4 MiB blocks", data, "a4", 4 * MIB, verify=False)
    before = S.sort_tiles.launches + S.merge_level.launches
    stream["a7 on"] = _encode_checked("a7 16 MiB / 4 MiB blocks", data[: 16 * MIB], "a7", 4 * MIB)
    if S.sort_tiles.launches + S.merge_level.launches <= before:
        raise AssertionError("the a7 run launched no kernel")

    # planted repeat (the shape of tests/test_fast2.py's micro-tail cases):
    # ~3800 actives tied past the micro tail's reach -> micro, then cascade
    block = planted_repeat_block()
    seen = {"micro": 0, "cascade": 0}
    orig_micro, orig_cascade = batched._micro_round2, batched._narrow_cascade2

    def micro(*a, **kw):
        seen["micro"] += 1
        return orig_micro(*a, **kw)

    def cascade(*a, **kw):
        seen["cascade"] += 1
        return orig_cascade(*a, **kw)

    batched._micro_round2, batched._narrow_cascade2 = micro, cascade
    try:
        _encode_checked("a4 1 MiB planted repeat", block, "a4", MIB)
    finally:
        batched._micro_round2, batched._narrow_cascade2 = orig_micro, orig_cascade
    print(f"[main] planted repeat took micro rounds {seen['micro']}, cascade {seen['cascade']}")
    if not (seen["micro"] and seen["cascade"]):
        raise AssertionError(f"planted repeat missed the micro tail or the cascade: {seen}")
    return launches, data, stream


def planted_repeat_block(length: int = 1900) -> bytes:
    """1 MiB of random bits with a ``length``-byte repeat planted twice.  At
    1900 (the shape of tests/test_fast2.py's micro-tail cases) about 3800
    actives stay tied past the micro tail's reach; at 56 KiB a ninth of the
    suffixes stays tied, between the v1 sorters' two narrowed capacities."""
    import numpy as np

    rng = np.random.default_rng(13)
    block = rng.integers(0, 2, MIB, dtype=np.uint8)
    rep = rng.integers(0, 2, length, dtype=np.uint8)
    block[1000 : 1000 + length] = rep
    block[MIB // 2 : MIB // 2 + length] = rep
    return block.tobytes()


def _counted(label, fn, launch=True):
    """``fn()`` with the kernel launch counts zeroed before it; fails unless
    both kernels launched (``launch=True``).  Returns (result, seconds,
    launch counts)."""
    import torch

    from archon_tpu_torch.ops import sort as S

    torch.cuda.synchronize()
    S.sort_tiles.launches = S.merge_level.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"sort_tiles": S.sort_tiles.launches, "merge_level": S.merge_level.launches}
    if launch and min(launches.values()) <= 0:
        raise AssertionError(f"{label}: a sort kernel never launched: {launches}")
    return out, dt, launches


def phase_a6(data: bytes) -> None:
    """a6 encode and decode on the card, each coder, against the input and the
    a7 reference BWT."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core import a6

    size = len(data)
    for config in ("byte", "fix", "var"):
        blob, enc_dt, launches = _counted(
            f"a6 {config} encode", lambda: port.a6_encode(data, config, device="cuda"))
        # var decodes on the native host walk and launches no sort kernel
        back, dec_dt, dec_launches = _counted(
            f"a6 {config} decode", lambda: port.a6_decode(blob, config, device="cuda"),
            launch=config != "var")
        if back != data:
            raise AssertionError(f"a6 {config}: decode does not give the input back")
        via = "native host walk" if config == "var" else "device inverse"
        print(f"[a6] {config}: {size} bytes -> {len(blob)}; encode {enc_dt:.4f} s = "
              f"{size / 1e6 / enc_dt:.2f} MB/s (launches {launches}); decode ({via}) "
              f"{dec_dt:.4f} s = {size / 1e6 / dec_dt:.2f} MB/s (launches {dec_launches}); "
              f"round trip ok")

    # the device part of one encode: the n-symbol transform alone
    arr = np.frombuffer(data, np.uint8)
    t = torch.from_numpy(arr.copy()).cuda()
    code_map = torch.from_numpy(a6._symbol_rank_map(a6.build_codes(arr, "var"))).cuda()
    sym_ms = _time_ms(lambda: a6._a6_symbol_transform(t, code_map))
    print(f"[a6] _a6_symbol_transform on {size} bytes (var table): {sym_ms:.3f} ms "
          f"(CUDA events, incl. its host syncs)")

    block = data[: 4 * MIB]
    L, base = bwt_reference(block, "a7")
    if port.a6_encode(block, "byte", device="cuda") != np.uint32(base).tobytes() + L.tobytes():
        raise AssertionError("a6 byte blob of 4 MiB differs from the a7 reference BWT")
    print("[a6] byte blob of 4 MiB == u32 base | L of the a7 reference BWT")

    arr = np.frombuffer(data[:MIB], np.uint8)
    for config in ("fix", "var"):
        (bits, sym), dt, _ = _counted(f"a6 {config} bit path", lambda: (
            a6.a6_forward(arr, config, impl="bits", device="cuda"),
            a6.a6_forward(arr, config, impl="symbol", device="cuda")))
        if bits[1] != sym[1] or not np.array_equal(bits[0], sym[0]):
            raise AssertionError(f"a6 {config}: bit path differs from the symbol path on 1 MiB")
        print(f"[a6] {config} on 1 MiB: bit path == symbol path ({dt:.4f} s for both)")

    one = b"\x07" * MIB
    blob = port.a6_encode(one, "var", device="cuda")
    if port.a6_decode(blob, "var", device="cuda") != one:
        raise AssertionError("a6 var: single-symbol input does not round-trip")
    blob = port.a6_encode(block, "byte", order="freq", device="cuda")
    if blob[:4] != b"AO1\xff" or port.a6_decode(blob, "byte", device="cuda") != block:
        raise AssertionError("a6 -o freq: 4 MiB does not round-trip")
    print("[a6] single-symbol var 1 MiB and -o freq 4 MiB round trips ok")


def phase_inverse(data: bytes) -> None:
    """The device inverse BWT through ``formats.decode(..., device="cuda")``."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core.unbwt import lf_successor, pointer_walk

    for generation in ("a4", "a7"):
        sentinel = "small" if generation == "a4" else "large"
        blob = port.encode(data, generation, device="cuda")
        dev_out, dev_dt, launches = _counted(
            f"{generation} device inverse", lambda: port.decode(blob, generation, device="cuda"))
        t0 = time.perf_counter()
        host_out = port.decode(blob, generation)
        host_ms = (time.perf_counter() - t0) * 1e3
        if not dev_out == host_out == data:
            raise AssertionError(f"{generation}: device inverse differs from the input or host walk")
        L = torch.from_numpy(np.frombuffer(blob[:-4], np.uint8).copy()).cuda()
        base = int(np.frombuffer(blob[-4:], np.uint32)[0])
        P = lf_successor(L, base, sentinel)
        lf_ms = _time_ms(lambda: lf_successor(L, base, sentinel))
        walk_ms = _time_ms(lambda: pointer_walk(L, P, base))
        print(f"[inverse] {generation} {len(data)} bytes: decode(device='cuda') {dev_dt * 1e3:.3f} ms "
              f"(launches {launches}) == input == host walk; lf_successor {lf_ms:.3f} ms + "
              f"pointer_walk {walk_ms:.3f} ms (CUDA events); host walk {host_ms:.3f} ms")
        for n in (5000, 1):
            small = data[:n]
            if port.decode(port.encode(small, generation, device="cuda"), generation,
                           device="cuda") != small:
                raise AssertionError(f"{generation}: device inverse fails at n={n}")
    print("[inverse] n = 5000 (doubling branch) and n = 1 round trips ok")


def phase_breakdown(block: bytes) -> None:
    """Where one 4 MiB block's time goes: the device transform, the host walk."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core.fast2 import bwt_v3

    arr = torch.from_numpy(np.frombuffer(block[::-1], np.uint8).copy()).cuda()
    bwt_ms = _time_ms(lambda: bwt_v3(arr, "small"))
    blob = port.encode_file(block, "a4", len(block), verify=False, impl="stream", device="cuda")
    t0 = time.perf_counter()
    for _ in range(3):
        port.decode_file(blob)
    walk_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"[breakdown] one {len(block)}-byte text block: bwt_v3 {bwt_ms:.3f} ms "
          f"(CUDA events, incl. its host syncs); host LF walk (decode_file) {walk_ms:.3f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bwt_v3(arr, "small")
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): the host ops that launched
    # them carry the same time again
    rows = sorted(
        ((ev.self_device_time_total, ev.count, ev.key) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    if not rows:
        print("[breakdown] torch.profiler recorded no device time: not measured")
        return
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    print(f"[breakdown] profiled bwt_v3: device busy {busy_ms:.3f} ms; against the "
          f"unprofiled {bwt_ms:.3f} ms, idle share {1 - busy_ms / bwt_ms:.3f}")
    for us, count, key in rows[:10]:
        print(f"[breakdown]   {us / 1e3:8.3f} ms  x{count:<4d} {key[:90]}")


HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet: 80 GB of HBM at 3.35 TB/s
INT32_OPS_PER_S = 33.5e12  # half the 67 TFLOP/s float32 rate: one comparison an instruction


def kernel_bounds(n: int, num_keys: int, carried: int, tile: int, n_pad: int) -> dict:
    """The least time the card could take for K1 and for one K2 level on a
    sort of ``n`` elements: bytes each must move once (K1 reads the carried
    key rows and writes the tuples; a K2 level reads and writes the tuples)
    over the memory rate, against the comparisons a sort of tiles (log2 of
    the tile per element) or a merge (one per element) needs, each over the
    carried keys, over the int32 rate."""
    import math

    def bound(nbytes, ops):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
        return {"bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations"}

    tuple_bytes = (carried + 1) * 4 * n_pad
    return {"sort_tiles": bound(carried * 4 * n + tuple_bytes, n * math.log2(tile) * carried),
            "merge_level": bound(2 * tuple_bytes, n_pad * carried)}


def stage_bound_ms(n: int, num_keys: int, payload_bytes: int) -> float:
    """The least time the card could take for one merge-split stage of ``n``
    kept elements: every key and payload column read once and written once,
    over the memory rate (a merge makes one comparison an element)."""
    return 2 * n * (4 * num_keys + payload_bytes) / HBM_BYTES_PER_S * 1e3


def check_sort_rows(name, keys, payloads, tag="sort_rows"):
    """``sort_rows`` on these operands against ``sort_rows_ref``, and its
    launches (K1 once, K2 once per level up to the row width); raises unless
    both are as they should be."""
    import torch

    from archon_tpu_torch.ops import sort as S

    S.sort_tiles.launches = S.merge_level.launches = 0
    got = S.sort_rows(keys, payloads)
    k1, k2 = S.sort_tiles.launches, S.merge_level.launches
    want = S.sort_rows_ref(keys, payloads)
    e = max(_max_err(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    KERNEL_ERR["merge_level"] = max(KERNEL_ERR["merge_level"], e)
    B, n = keys[0].shape
    print(f"[{tag}] {name}: ({B}, {n}) keys={len(keys)} payloads={len(payloads)} "
          f"row width {S.row_width(B, n)}; launches K1 {k1}, K2 {k2}; max_abs_err {e} "
          f"{'ok' if e == 0 else 'MISMATCH'}")
    if e or k1 != 1 or k2 != (S.row_width(B, n) // S.TILE - 1).bit_length():
        raise AssertionError(f"sort_rows disagrees with its plain twin or its launches: {name}")


def phase_sort_rows() -> None:
    """``sort_rows`` against ``sort_rows_ref`` on the card, exact, at the
    batched path's shapes; launches per call; timed at (8, 2^22)."""
    import numpy as np
    import torch

    from archon_tpu_torch.ops import sort as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(4)

    def operands(B, n, count, hi):
        return [torch.from_numpy(rng.integers(-1, hi, (B, n)).astype(np.int32)).to(dev)
                for _ in range(count)]

    check = check_sort_rows

    B, n = 8, 1 << 22
    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    prev = torch.from_numpy(rng.integers(0, 256, (B, n), dtype=np.uint8)).to(dev)
    round_keys = operands(B, n, 4, n // 64)
    check("full round (4 keys; index, prev u8)", round_keys, [iota, prev])
    for count in (13, 49):
        check(f"micro tail ({count} keys; positions)", operands(B, 4096, count, 4),
              operands(B, 4096, 1, 4096))
    rank2 = torch.stack([torch.randperm(n, device=dev) for _ in range(B)]).to(torch.int32)
    cert = [operands(B, n, 1, 256)[0], operands(B, n, 1, n)[0], prev]
    check("certificate (1 key; 3 payloads)", [rank2], cert)
    ragged = operands(3, 20_011, 2, 3)
    ragged[0][:, ::5] = 0x7FFFFFFF  # real keys equal to the padding key
    check("ragged rows", ragged, [ragged[1] > 0, operands(3, 20_011, 1, 9)[0].to(torch.uint8)])
    check("one row, ragged", operands(1, 100_003, 2, 50), [])

    for label, keys, payloads in (("full round", round_keys, [iota, prev]),
                                  ("certificate", [rank2], cert)):
        ms = _time_ms(lambda: S.sort_rows(keys, payloads))
        plain = _time_ms(lambda: S.sort_rows_ref(keys, payloads))
        print(f"[sort_rows] ({B}, {n}) {label}: sort_rows {ms:.3f} ms "
              f"(plain torch.sort passes along dim 1: {plain:.3f} ms)")
    ms = _time_ms(lambda: [S.sort_operands([k[b] for k in round_keys], [iota[b], prev[b]])
                           for b in range(B)])
    print(f"[sort_rows] ({B}, {n}) full round, row by row through sort_operands: {ms:.3f} ms")
    for count in (13, 49):
        keys, pos = operands(B, 4096, count, 4), operands(B, 4096, 1, 4096)
        ms = _time_ms(lambda: S.sort_rows(keys, pos))
        loop = _time_ms(lambda: [S.sort_operands([k[b] for k in keys], [pos[0][b]])
                                 for b in range(B)])
        print(f"[sort_rows] ({B}, 4096) x {count} keys: sort_rows {ms:.3f} ms, row by row {loop:.3f} ms")


def phase_batched(text: bytes, stream: dict) -> dict:
    """The batched container path against the stream's containers; returns
    the kernel launch counts of the 64 MiB micro run with verify on."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core import batched
    from archon_tpu_torch.io import blocks
    from archon_tpu_torch.ops import sort as S

    block = 4 * MIB
    _encode_checked("warm-up, a4 8 MiB micro (not a measurement)", text[: 2 * block], "a4", block,
                    impl="micro")
    S.sort_tiles.launches = S.merge_level.launches = 0
    batched.stats.reset()
    dt_on, _ = _encode_checked("a4 64 MiB / 4 MiB blocks", text, "a4", block, impl="micro",
                               same_as=stream["a4 on"][1])
    launches = {"sort_tiles": S.sort_tiles.launches, "merge_level": S.merge_level.launches}
    print(f"[batched] a4 64 MiB micro run: kernel launches {launches}, rounds "
          f"{batched.stats.rounds}, host syncs {batched.stats.host_syncs} (2 units of 8 rows)")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the batched path never launched: {launches}")
    dt_off, _ = _encode_checked("a4 64 MiB / 4 MiB blocks", text, "a4", block, verify=False,
                                impl="micro", same_as=stream["a4 off"][1])
    dt_v3, _ = _encode_checked("a7 16 MiB / 4 MiB blocks", text[: 16 * MIB], "a7", block,
                               impl="v3", same_as=stream["a7 on"][1])
    mb = len(text) / 1e6
    print(f"[batched] a4 64 MiB MB/s, micro against stream in this run: verify on "
          f"{mb / dt_on:.2f} / {mb / stream['a4 on'][0]:.2f}, verify off {mb / dt_off:.2f} / "
          f"{mb / stream['a4 off'][0]:.2f}; a7 16 MiB v3 {mb / 4 / dt_v3:.2f} / stream "
          f"{mb / 4 / stream['a7 on'][0]:.2f}")

    # the unit's size: rows per dispatch unit, through ARCHON_PIPE_BLOCKS
    rates = []
    for pipe in (1, 8, 16):
        os.environ["ARCHON_PIPE_BLOCKS"] = str(pipe)
        try:
            got, dt, _ = _counted(f"micro, units of {pipe}", lambda: port.encode_file(
                text, "a4", block, verify=False, impl="micro", device="cuda"))
        finally:
            del os.environ["ARCHON_PIPE_BLOCKS"]
        if got != stream["a4 off"][1]:
            raise AssertionError(f"micro with units of {pipe} rows differs from the stream's")
        rates.append(f"{pipe}: {mb / dt:.2f}")
    print(f"[batched] a4 64 MiB micro, verify off, MB/s by rows per unit (ARCHON_PIPE_BLOCKS): "
          f"{', '.join(rates)}; every container == stream's")

    # one unit of 8 rows apart: first the host's share of it, step by step
    # as io.blocks._batched_forward does them
    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    unit = [text[i * block : (i + 1) * block] for i in range(8)]
    rows, stack_ms = host_ms(lambda: np.stack([np.frombuffer(b, np.uint8) for b in unit]))
    data2, h2d_ms = host_ms(lambda: torch.from_numpy(rows).cuda().flip(1))
    (L2, base2, _), _ = host_ms(lambda: batched.bwt_batched_micro(data2, "small"))
    L_host, d2h_ms = host_ms(lambda: L2.cpu().numpy())
    base_host = base2.cpu().numpy()
    results = [(L_host[t], int(base_host[t])) for t in range(8)]
    _, frame_ms = host_ms(lambda: b"".join(
        piece for frame in blocks._frames(unit, results, pack=False) for piece in frame))
    print(f"[batched] host steps of one unit (8, {block}), host clock: stack {stack_ms:.3f} ms, "
          f"copy to the card and reverse there {h2d_ms:.3f} ms, copy back {d2h_ms:.3f} ms, "
          f"frames joined {frame_ms:.3f} ms")
    for label, fn in (("micro", batched.bwt_batched_micro),
                      ("micro_certified", batched.bwt_batched_micro_certified),
                      ("v3", batched.bwt_batched_v3),
                      ("v3_certified", batched.bwt_batched_v3_certified)):
        ms = _time_ms(lambda: fn(data2, "small"))
        torch.cuda.reset_peak_memory_stats()
        batched.stats.reset()
        _, _, unit_launches = _counted(f"unit {label}", lambda: fn(data2, "small"))
        print(f"[batched] one unit (8, {block}) {label}: {ms:.3f} ms = {ms / 8:.3f} ms a block "
              f"(CUDA events, incl. its host syncs); rounds {batched.stats.rounds}, host syncs "
              f"{batched.stats.host_syncs}, launches {unit_launches}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / MIB:.0f} MiB")
    L, base, rank = batched._bwt_batched_v3_impl(data2, torch.roll(data2, 1, dims=1), "small",
                                                 want_rank=True)
    cert_ms = _time_ms(lambda: batched.verify_bwt_batched(data2, rank, L, base, "small"))
    ok = batched.verify_bwt_batched(data2, rank, L, base, "small")
    bad_L = L.clone()
    bad_L[3, 12345] ^= 0xFF
    bad = batched.verify_bwt_batched(data2, rank, bad_L, base, "small")
    print(f"[batched] verify_bwt_batched on the unit: {cert_ms:.3f} ms (CUDA events); ok "
          f"{ok.tolist()}; with one byte of row 3's L flipped {bad.tolist()}")
    if not bool(ok.all()) or bad.tolist() != [i != 3 for i in range(8)]:
        raise AssertionError("the certificate passed a corrupted L or failed a right one")

    # a row the micro program cannot resolve, beside three it can
    mixed = planted_repeat_block() + text[: 3 * MIB]
    want = port.encode_file(mixed, "a4", MIB, impl="stream", device="cuda")
    for verify in (True, False):
        blocks._fallback_row.calls = 0
        got, dt, _ = _counted("fallback file", lambda: port.encode_file(
            mixed, "a4", MIB, verify=verify, impl="micro", device="cuda"))
        print(f"[batched] planted repeat + 3 text blocks of 1 MiB, micro, verify "
              f"{'on' if verify else 'off'}: {blocks._fallback_row.calls} row(s) through "
              f"_fallback_row, {dt:.4f} s; == stream container: {got == want}")
        if got != want or blocks._fallback_row.calls < 1:
            raise AssertionError("the fallback file differs from the stream's or no row fell back")
    return launches


def pack_bounds(state, nwords: int) -> dict:
    """Bytes each pack kernel needs, each input read once and each output
    written once, by kernel of ``csrc/pack.cu``: L (1 B a byte), the chunks'
    stamp tables (1 KiB a chunk), symbols (2 B each), chunk histograms and
    records (4 B an entry), each chunk's first bit (8 B), the words."""
    B, n = state.syms.shape
    chunks = B * state.meta.shape[1]
    syms = 2 * int(state.meta[..., 0].sum())
    stamps, hists = 1024 * chunks, 4 * state.chist.shape[2] * chunks
    meta = 4 * state.meta.shape[2] * chunks
    return {"pack_occ_kernel": B * n + stamps, "pack_occ_scan_kernel": 2 * stamps,
            "pack_mtf_kernel": B * n + stamps + syms + hists + meta,
            "pack_rle_scan_kernel": 2 * (meta + hists),
            "pack_bits_scan_kernel": hists + 8 * chunks,
            "pack_words_kernel": syms + meta + 8 * chunks + 4 * nwords}


def _kernel_ms(fn, pattern: str, calls: int = TIMED_CALLS) -> dict:
    """Device milliseconds a call of ``fn`` by kernel name (the names that
    ``pattern`` finds), from ``torch.profiler``'s CUDA events."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m and e.device_type == DeviceType.CUDA:
            out[m.group(0)] = out.get(m.group(0), 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def phase_pack(text: bytes) -> tuple:
    """The ATA2 pack on the card (``ops.pack``, ``entropy.pack.RowPack``):
    each kernel call against its twin on one 4 MiB text BWT row, both timed
    on an (8, 4 MiB) unit and each kernel beside its byte bound, and the
    unit's payloads equal to ``pack_block``'s, each path's host time beside
    the other's; then the main path, ``encode_file(pack=True)`` over a unit
    and a ragged tail, equal to the host pack's bytes, with each kernel's
    launches counted in that run alone.  Returns the stats and one entry a
    kernel for the JSON line."""
    import numpy as np
    import torch

    from archon_tpu_torch.core.fast2 import bwt_v3
    from archon_tpu_torch.entropy import pack
    from archon_tpu_torch.io import blocks
    from archon_tpu_torch.ops import pack as P

    block = 4 * MIB
    L = torch.stack([bwt_v3(torch.frombuffer(bytearray(text[i * block : (i + 1) * block]),
                                             dtype=torch.uint8).cuda(), "small")[0]
                     for i in range(8)])
    t0 = time.perf_counter()
    twin = P.mtf_rle_ref(L[:1].cpu(), P.PACK_CHUNK)
    twin_ms = (time.perf_counter() - t0) * 1e3
    got = P.mtf_rle(L[:1].contiguous(), P.PACK_CHUNK)
    for field in ("meta", "chist", "head"):
        if not torch.equal(getattr(got, field).cpu(), getattr(twin, field)):
            raise AssertionError(f"mtf_rle's {field} differs from its twin's on a text row")
    if not torch.equal(P.symbols(got)[0], P.symbols(twin)[0]):
        raise AssertionError("mtf_rle's symbols differ from its twin's on a text row")
    head = twin.head.numpy()
    hist = head[0, : P.NSYM].astype(np.int64)
    present = np.nonzero(hist)[0]
    vals, lens, _maxlen = pack._codes_for(present, hist[present])
    nwords = (int(hist @ lens.astype(np.int64)) + 31) // 32
    codes = torch.from_numpy(vals.view(np.int32).copy())[None]
    lens_t = torch.from_numpy(lens.astype(np.int32))[None]
    first = torch.zeros(1, dtype=torch.int64)
    t0 = time.perf_counter()
    twin_words = P.pack_words_ref(twin, codes, lens_t, first, nwords)
    twin_words_ms = (time.perf_counter() - t0) * 1e3
    words = P.pack_words(got, codes.cuda(), lens_t.cuda(), first.cuda(), nwords)
    if not torch.equal(words.cpu(), twin_words):
        raise AssertionError("pack_words differs from its twin on a text row")
    print(f"[pack] one 4 MiB text BWT row: mtf_rle and pack_words == their twins (m "
          f"{int(head[0, P.NSYM])}, {nwords} words); twins {twin_ms:.1f} / {twin_words_ms:.1f} ms "
          f"on the host")

    state = P.mtf_rle(L)
    heads = state.head.cpu().numpy()
    tables = [pack._codes_for(np.nonzero(h[: P.NSYM])[0], h[: P.NSYM][np.nonzero(h[: P.NSYM])[0]])
              for h in heads.astype(np.int64)]
    sizes = [(int(h[: P.NSYM].astype(np.int64) @ t[1].astype(np.int64)) + 31) // 32
             for h, t in zip(heads, tables)]
    codes8 = torch.from_numpy(np.stack([t[0] for t in tables]).view(np.int32)).cuda()
    lens8 = torch.from_numpy(np.stack([t[1] for t in tables]).astype(np.int32)).cuda()
    first8 = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)).cuda()
    total = int(sum(sizes))
    launches = (P.mtf_rle.launches, P.pack_words.launches)
    mtf_ms = _time_ms(lambda: P.mtf_rle(L))
    words_ms = _time_ms(lambda: P.pack_words(state, codes8, lens8, first8, total))
    print(f"[pack] (8, {block}) unit, chunk {P.PACK_CHUNK}: mtf_rle {mtf_ms:.3f} ms, pack_words "
          f"{words_ms:.3f} ms (CUDA events)")
    bounds = pack_bounds(state, total)
    per_kernel = {**_kernel_ms(lambda: P.mtf_rle(L), r"pack_\w+_kernel"),
                  **_kernel_ms(lambda: P.pack_words(state, codes8, lens8, first8, total),
                               r"pack_\w+_kernel")}
    if set(per_kernel) != set(bounds):
        raise AssertionError(f"the profiler saw pack kernels {sorted(per_kernel)}, not all six")
    for name, nbytes in bounds.items():
        print(f"[pack]   {name}: {per_kernel[name]:.4f} ms (torch.profiler), bound "
              f"{nbytes / 3.35e9:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s)")

    rows = list(range(8))
    pack.RowPack(L).payloads(rows)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pack.RowPack(L).payloads(rows)
    row_ms = (time.perf_counter() - t0) * 1e3
    L_host = L.cpu().numpy()
    t0 = time.perf_counter()
    want = [pack.pack_block(row) for row in L_host]
    host_ms = (time.perf_counter() - t0) * 1e3
    if got != want:
        raise AssertionError("RowPack's payloads differ from pack_block's on the unit")
    ratio = sum(map(len, got)) / (8 * block)
    print(f"[pack] (8, {block}) unit through RowPack == pack_block row by row (ratio "
          f"{100 * ratio:.3f}%): RowPack {row_ms:.2f} ms on the host clock, pack_block "
          f"{host_ms:.2f} ms on one thread")
    counts = {"mtf_rle": P.mtf_rle.launches - launches[0],
              "pack_words": P.pack_words.launches - launches[1]}
    if min(counts.values()) <= 0:
        raise AssertionError(f"a pack kernel never launched: {counts}")

    k = 10  # a unit of 8 rows, then a ragged tail of 2: two units, so two calls of each
    data = text[: k * block]
    s = pack.stats
    before = s.device_blocks
    P.mtf_rle.launches = P.pack_words.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = blocks.encode_file(data, "a4", block, pack=True, impl="micro", device="cuda")
    file_s = time.perf_counter() - t0
    path = {"mtf_rle": P.mtf_rle.launches, "pack_words": P.pack_words.launches}
    device_blocks = s.device_blocks - before
    want = blocks.encode_file(data, "a4", block, pack=True, impl="stream", device="cuda")
    if got != want:
        raise AssertionError("encode_file(pack=True) on the card differs from the host pack's container")
    if path != {"mtf_rle": 2, "pack_words": 2} or device_blocks < 1:
        raise AssertionError(f"encode_file(pack=True) on {k} blocks: launches {path}, "
                             f"{device_blocks} device block(s)")
    print(f"[pack] encode_file a4 {k * block >> 20} MiB, pack=True, micro: {file_s:.4f} s, == the "
          f"host pack's container; mtf_rle {path['mtf_rle']} / pack_words {path['pack_words']} calls, "
          f"{device_blocks} of {k} blocks packed on the card")
    kernels = [{"name": name, "route": "cuda", "source": PACK_SOURCE, "replaces": None,
                "call": call, "launches": path[call], "ms": per_kernel[name],
                "bound_ms": bounds[name] / 3.35e9, "bound_by": "bytes at 3.35 TB/s"}
               for call, names in PACK_CALLS.items() for name in names]
    stats = {"mtf_rle_ms": mtf_ms, "pack_words_ms": words_ms, "twin_ms": twin_ms,
             "twin_words_ms": twin_words_ms, "row_pack_ms": row_ms, "pack_block_ms": host_ms,
             "encode_file_s": file_s, "device_blocks": device_blocks}
    return stats, kernels


def phase_resume(text: bytes, stream: dict) -> None:
    """``encode_to_path`` cut and resumed, input drift, ``extract_block``."""
    import archon_tpu_torch as port
    from archon_tpu_torch.io import blocks
    from archon_tpu_torch.ops._build import BUILD_DIR

    block = 4 * MIB
    want = stream["a4 on"][1]
    path = BUILD_DIR / "chip_smoke_resume.ata"
    frame = 4 + block + 4
    try:
        t0 = time.perf_counter()
        n_all = port.encode_to_path(text, path, "a4", block, device="cuda")
        dt_all = time.perf_counter() - t0
        if n_all != 16 or path.read_bytes() != want:
            raise AssertionError("encode_to_path differs from encode_file")
        with open(path, "r+b") as f:
            f.truncate(12 + 8 * frame + frame // 2)  # 8 whole frames and half of the ninth
        t0 = time.perf_counter()
        n_cut = port.encode_to_path(text, path, "a4", block, resume=True, device="cuda")
        dt_cut = time.perf_counter() - t0
        if n_cut != 8 or path.read_bytes() != want:
            raise AssertionError(f"resume after a cut recomputed {n_cut} blocks or wrote other bytes")
        if port.encode_to_path(text, path, "a4", block, resume=True, device="cuda") != 0:
            raise AssertionError("resume over a complete container recomputed blocks")
        with open(path, "r+b") as f:
            f.truncate(12 + 8 * frame)
        at = 7 * block + 4321  # inside the last kept block
        drifted = text[:at] + bytes([text[at] ^ 1]) + text[at + 1 :]
        t0 = time.perf_counter()
        n_drift = port.encode_to_path(drifted, path, "a4", block, resume=True, device="cuda")
        dt_drift = time.perf_counter() - t0
        if n_drift != 16 or port.decode_file(path.read_bytes()) != drifted:
            raise AssertionError(f"resume after input drift recomputed {n_drift} blocks, not all")
    finally:
        if path.exists():
            os.unlink(path)
    print(f"[resume] encode_to_path a4 64 MiB: {n_all} blocks in {dt_all:.4f} s == encode_file; "
          f"cut in frame 8 and resumed: {n_cut} blocks in {dt_cut:.4f} s, same bytes; one input "
          f"byte changed in the last kept block: {n_drift} blocks in {dt_drift:.4f} s")
    packed = port.encode_file(text[: 16 * MIB], "a4", block, pack=True, impl="micro", device="cuda")
    one = blocks.extract_block(want, 3)
    single = port.encode(text[3 * block : 4 * block], "a4", device="cuda")
    if not one == blocks.extract_block(packed, 3) == single:
        raise AssertionError("extract_block of ATA1, of ATA2 and the a4 frame of block 3 differ")
    print(f"[resume] extract_block(3) of ATA1 == of ATA2 == the a4 blob of block 3 "
          f"({len(one)} bytes); ATA2 of 16 MiB: {len(packed)} bytes")


def _reversed_block(block: bytes):
    import numpy as np
    import torch

    return torch.from_numpy(np.frombuffer(block[::-1], np.uint8).copy()).cuda()


def _block_call(tag, label, fn, calls=TIMED_CALLS):
    """One call of a 1-D sorter apart: a first call counted for its rounds,
    host syncs and kernel launches, then ms over ``calls`` more by CUDA
    events.  Returns (result, ms, launches).  ``bwt_v3`` counts in
    ``core.batched.stats``, the other 1-D sorters in ``core.doubling.stats``."""
    from archon_tpu_torch.core import batched, doubling

    doubling.stats.reset()
    batched.stats.reset()
    out, _, launches = _counted(label, fn)
    rounds = doubling.stats.rounds + batched.stats.rounds
    syncs = doubling.stats.host_syncs + batched.stats.host_syncs
    ms = _events_ms(fn, calls)
    print(f"[{tag}] {label}: {ms:.3f} ms (CUDA events over {calls} call(s), incl. its host syncs); "
          f"rounds {rounds}, host syncs {syncs}, launches {launches}")
    return out, ms, launches


def _same_bwt(label, got, want) -> None:
    import torch

    if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
        raise AssertionError(f"{label}: (L, base) differs from bwt_v3's")


def phase_v1(text: bytes) -> dict:
    """The v1 sorters against ``bwt_v3`` and ``verify_sa``; returns the
    launches of ``bwt_forward_fast`` on the text block."""
    import torch

    from archon_tpu_torch.core import batched, bwt, doubling, fast, fast2
    from archon_tpu_torch.core.fast2 import bwt_v3

    fast_launches = None
    for name, block in (("4 MiB text block", text[: 4 * MIB]),
                        ("1 MiB planted repeat", planted_repeat_block()),
                        ("1 MiB planted 56 KiB repeat", planted_repeat_block(56 << 10))):
        arr = _reversed_block(block)
        # every shape of sort these sorters give the kernels (the 1-key init
        # and compaction sorts, the narrowed rounds at both capacities with
        # their pads), each held to its twins before the results are
        sorts = _captured_sorts((fast, fast2, doubling), lambda: (
            doubling.suffix_array(arr, "small"), bwt.bwt_forward_fast(arr, "small")))
        for keys, payloads in sorts:
            check_sort(f"{name}, a sort of suffix_array or bwt_forward_fast", keys, payloads, "v1")
        widths = {k[0].shape[0] for k, _ in sorts if len(k) == 4}
        if "56 KiB" in name and widths != {MIB, MIB // 4, MIB // 32}:
            raise AssertionError(f"the long repeat's rounds ran at {widths}, not at n, n/4, n/32")
        want, v3_ms, _ = _block_call("v1", f"{name}, bwt_v3 (for comparison)",
                                     lambda: bwt_v3(arr, "small"))
        for label, fn in (("suffix_array", lambda: doubling.suffix_array(arr, "small")),
                          ("suffix_array_fast", lambda: fast.suffix_array_fast(
                              arr, "small", return_device=True))):
            sa, _, _ = _block_call("v1", f"{name}, {label}", fn)
            if not bool(bwt.verify_sa(arr, sa, "small")):
                raise AssertionError(f"{name}: verify_sa rejects {label}'s suffix array")
        for label, fn in (("bwt_forward", lambda: bwt.bwt_forward(arr, "small")),
                          ("bwt_forward_fast", lambda: bwt.bwt_forward_fast(arr, "small"))):
            got, _, launches = _block_call("v1", f"{name}, {label}", fn)
            _same_bwt(f"{name}, {label}", got, want)
            if not bool(bwt.verify_sa(arr, got[2] if label == "bwt_forward"
                                      else doubling.rank_of(got[2]), "small")):
                raise AssertionError(f"{name}: verify_sa rejects {label}'s suffix array")
            if label == "bwt_forward_fast" and fast_launches is None:
                fast_launches = launches
        print(f"[v1] {name}: suffix arrays certified by verify_sa; (L, base) of bwt_forward and "
              f"bwt_forward_fast == bwt_v3's")
    rows = torch.stack([_reversed_block(text[i * MIB : (i + 1) * MIB]) for i in range(2)]
                       + [_reversed_block(planted_repeat_block()),
                          _reversed_block(planted_repeat_block(56 << 10))])
    row_sorts = _captured_sorts((batched,), lambda: batched.bwt_forward_batched(rows, "small"),
                                attr="sort_rows")
    for keys, payloads in row_sorts:
        check_sort_rows("a sort of bwt_forward_batched", keys, payloads, "v1")
    if {k[0].shape[1] for k, _ in row_sorts} != {MIB, MIB // 4, MIB // 32}:
        raise AssertionError("bwt_forward_batched did not sort at n, n/4 and n/32")
    batched.stats.reset()
    (L2, base2, _), _, launches = _counted("bwt_forward_batched",
                                           lambda: batched.bwt_forward_batched(rows, "small"))
    rounds, syncs = batched.stats.rounds, batched.stats.host_syncs
    ms = _events_ms(lambda: batched.bwt_forward_batched(rows, "small"))
    for b in range(rows.shape[0]):
        _same_bwt(f"bwt_forward_batched row {b}", (L2[b], base2[b]), bwt_v3(rows[b], "small"))
    print(f"[v1] bwt_forward_batched, 2 text rows and both planted repeats of 1 MiB: {ms:.3f} ms "
          f"(CUDA events, incl. its host syncs); rounds {rounds}, host syncs {syncs}, launches "
          f"{launches}; every row == bwt_v3's")
    return fast_launches


def phase_sais(text: bytes) -> dict:
    """``bwt_sais`` on the 4 MiB text block against ``bwt_v3``; returns its
    launches for a4."""
    from archon_tpu_torch.core import doubling, sais_tpu
    from archon_tpu_torch.core.fast2 import bwt_v3

    arr = _reversed_block(text[: 4 * MIB])
    out = None
    capped_rounds, capped_ranks = [], sais_tpu._capped_ranks

    def counting(*args):
        before = doubling.stats.rounds
        ranks = capped_ranks(*args)
        capped_rounds.append(doubling.stats.rounds - before)
        return ranks

    for gen, sentinel in (("a4", "small"), ("a7", "large")):
        want, _, _ = _block_call("sais", f"4 MiB text block {gen}, bwt_v3 (for comparison)",
                                 lambda: bwt_v3(arr, sentinel))
        sais_tpu._capped_ranks = counting
        try:
            got, _, launches = _block_call("sais", f"4 MiB text block {gen}, bwt_sais",
                                           lambda: sais_tpu.bwt_sais(arr, sentinel), calls=1)
        finally:
            sais_tpu._capped_ranks = capped_ranks
        _same_bwt(f"bwt_sais {gen}", got, want)
        print(f"[sais] {gen}: (L, base) == bwt_v3's; joint-rank rounds of the naming, L and S "
              f"_capped_ranks: {capped_rounds[-3:]}")
        out = out or launches
    return out


def phase_it2(text: bytes, stream: dict):
    """IT-2 on one block, through the container and on Gauntlet blocks;
    returns the launches of the 64 MiB verify-on run and of one block."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core import doubling, fast2, it2
    from archon_tpu_torch.io import blocks
    from archon_tpu_torch.ops import sort as S
    from archon_tpu_torch.utils.corpus import gauntlet_cases

    block = 4 * MIB
    arr = _reversed_block(text[:block])
    n, D = arr.shape[0], 11
    M = it2._reduced_capacity(n)
    block_launches = None
    for gen, sentinel in (("a4", "small"), ("a7", "large")):
        want, v3_ms, _ = _block_call("it2", f"4 MiB text block {gen}, bwt_v3 (for comparison)",
                                     lambda: fast2.bwt_v3(arr, sentinel))
        (L, base, ok), it2_ms, launches = _block_call(
            "it2", f"4 MiB text block {gen}, bwt_it2", lambda: it2.bwt_it2(arr, sentinel),
            calls=1)
        if not ok:
            raise AssertionError(f"bwt_it2 {gen}: ok is false on a text block")
        _same_bwt(f"bwt_it2 {gen}", (L, base), want)
        print(f"[it2] {gen}: ok, (L, base) == bwt_v3's; bwt_it2 {it2_ms:.3f} ms against bwt_v3 "
              f"{v3_ms:.3f} ms in this run")
        block_launches = block_launches or launches
    prev = torch.roll(arr, 1)
    (keys, dist, s1, bad_name, overflow), stage1_ms = _timed(
        lambda: it2._it2_stage1(arr, D, M), calls=1)
    # _timed calls twice (warm-up, timed): the round counts below are halved
    doubling.stats.reset()
    r_star, solve_ms = _timed(lambda: fast2.suffix_ranks_windows(s1, 1, "small"), calls=1)
    solve_rounds = doubling.stats.rounds // 2
    merged, merge_ms = _timed(lambda: it2._it2_merge(arr, prev, keys, dist, r_star, D), calls=1)
    na = int(merged[2])
    m = int(it2._lucky_mask(arr.to(torch.int32)).sum())
    # the reduced string is padded with zeros from m to M, one run that ties
    # as deep as it is long: the same solve without the padding, for the record
    cut = s1[:m].contiguous()
    doubling.stats.reset()
    r_cut, cut_ms = _timed(lambda: fast2.suffix_ranks_windows(cut, 1, "small"), calls=1)
    cut_rounds = doubling.stats.rounds // 2
    if not torch.equal(r_cut + (M - m), r_star[:m]):
        raise AssertionError("the reduced ranks without the zero padding are not the padded ones")
    print(f"[it2] stages on the a4 block (CUDA events, one call each after a warm-up): naming _it2_stage1 {stage1_ms:.3f} ms, "
          f"reduced solve suffix_ranks_windows at M={M} {solve_ms:.3f} ms ({solve_rounds} rounds), "
          f"_it2_merge {merge_ms:.3f} ms; m/n = {m}/{n} = {m / n:.4f}, na = {na}, bad_name "
          f"{bool(bad_name)}, overflow {bool(overflow)}")
    print(f"[it2] the reduced solve on the {m} names alone, without the {M - m} zeros of padding "
          f"(not what the port runs): {cut_ms:.3f} ms ({cut_rounds} rounds), the same ranks")

    mb = len(text) / 1e6
    _encode_checked("warm-up, a4 8 MiB it2 (not a measurement)", text[: 2 * block], "a4", block,
                    impl="it2")
    blocks._streamed_forward.it2_fallbacks = 0
    S.sort_tiles.launches = S.merge_level.launches = 0
    dt_on, _ = _encode_checked("a4 64 MiB / 4 MiB blocks", text, "a4", block, impl="it2",
                               same_as=stream["a4 on"][1])
    launches = {"sort_tiles": S.sort_tiles.launches, "merge_level": S.merge_level.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the it2 path never launched: {launches}")
    dt_off, _ = _encode_checked("a4 64 MiB / 4 MiB blocks", text, "a4", block, verify=False,
                                impl="it2", same_as=stream["a4 off"][1])
    fell = blocks._streamed_forward.it2_fallbacks
    print(f"[it2] a4 64 MiB MB/s, it2 against stream in this run: verify on {mb / dt_on:.2f} / "
          f"{mb / stream['a4 on'][0]:.2f}, verify off {mb / dt_off:.2f} / "
          f"{mb / stream['a4 off'][0]:.2f}; kernel launches of the verify-on run {launches}; "
          f"blocks that fell back to bwt_v3 in both runs: {fell}")
    if fell:
        raise AssertionError(f"{fell} text block(s) fell back to bwt_v3")

    cases = gauntlet_cases(MIB)
    verdicts = []
    for name in ("zeros", "fibonacci", "nested", "period_long", "random"):
        g = _reversed_block(cases[name])
        L, base, ok = it2.bwt_it2(g, "small")
        if ok:
            _same_bwt(f"bwt_it2 on Gauntlet {name}", (L, base), fast2.bwt_v3(g, "small"))
        verdicts.append(f"{name} {'exact' if ok else 'flagged'}")
    data = b"".join(cases[name] for name in ("zeros", "fibonacci", "nested", "period_long",
                                              "random"))
    want = port.encode_file(data, "a4", MIB, impl="stream", device="cuda")
    blocks._streamed_forward.it2_fallbacks = 0
    got, dt, _ = _counted("Gauntlet file", lambda: port.encode_file(
        data, "a4", MIB, impl="it2", device="cuda"))
    print(f"[it2] Gauntlet blocks of 1 MiB through bwt_it2: {', '.join(verdicts)}; as one file of "
          f"{len(data)} bytes through impl it2: {blocks._streamed_forward.it2_fallbacks} block(s) "
          f"fell back to bwt_v3, {dt:.4f} s; == stream container: {got == want}")
    if got != want or port.decode_file(got) != data:
        raise AssertionError("the Gauntlet container of impl it2 differs from the stream's")
    if not blocks._streamed_forward.it2_fallbacks:
        raise AssertionError("no Gauntlet block took the bwt_v3 fallback")
    return launches, block_launches


def _hold_rows_sort(name, keys, payloads, levels=True):
    """A ``sort_rows`` call of the megablock against its twins: with
    ``levels``, K1 and every K2 level up to the row width on the batch's
    flat key matrix (the rows fill their width, so it is the operands laid
    end to end), then the whole ``sort_rows``."""
    import torch

    from archon_tpu_torch.ops import sort as S

    B, n = keys[0].shape
    if S.row_width(B, n) != n:
        raise AssertionError(f"{name}: rows of {n} do not fill their row width")
    if levels:
        mat = torch.stack([k.contiguous() for k in keys]).view(len(keys), B * n)
        tuples = S.sort_tiles(mat)
        e1 = _max_err(tuples, S.sort_tiles_ref(mat))
        run, e2 = S.TILE, 0
        while run < n:
            nxt = S.merge_level(mat, tuples, run)
            e2 = max(e2, _max_err(nxt, S.merge_level_ref(mat, tuples, run)))
            tuples, run = nxt, run * 2
        KERNEL_ERR["sort_tiles"] = max(KERNEL_ERR["sort_tiles"], e1)
        KERNEL_ERR["merge_level"] = max(KERNEL_ERR["merge_level"], e2)
        print(f"[megablock] {name}: K1 tile_err={e1}, K2 levels up to the row merge_err={e2}")
        if e1 or e2:
            raise AssertionError(f"kernel disagrees with its plain twin: {name}")
    check_sort_rows(name, keys, payloads, "megablock")


def _merge_level_stage(mine, partner, rows, keep_low, num_keys):
    """A merge-split stage in the form that ``stage_merge`` replaced: the
    partner's rows copied, ``[mine, partner]`` concatenated, one K2 merge
    level over both halves (``merge_rows``), the kept half selected."""
    import torch

    from archon_tpu_torch.ops import sort as S

    w = mine[0].shape[1]
    both = [torch.cat([a, torch.stack([b[r] for r in rows])], dim=1) for a, b in zip(mine, partner)]
    merged = S.merge_rows(both[:num_keys], both[num_keys:])
    return [torch.where(keep_low, mg[:, :w], mg[:, w:]) for mg in merged]


_merge_level_stage.launches = 0  # megablock reads its stage op's launch count


def _captured_stages(run) -> list:
    """The merge-split stages that ``run()`` makes through
    ``megablock.stage_merge``, as (mine, partner, rows, keep_low, num_keys):
    the first of each shape (key count, payload count, operand shape)."""
    from archon_tpu_torch.parallel import megablock as mb

    real, seen, shapes = mb.stage_merge, [], set()

    def capture(mine, partner, rows, keep_low, num_keys):
        shape = (num_keys, len(mine) - num_keys, tuple(mine[0].shape))
        if shape not in shapes:
            shapes.add(shape)
            seen.append((list(mine), list(partner), list(rows), keep_low, num_keys))
        out = real(mine, partner, rows, keep_low, num_keys)
        capture.launches = real.launches
        return out

    capture.launches = real.launches
    mb.stage_merge = capture
    try:
        run()
    finally:
        mb.stage_merge = real
    return seen


def _stage_shape(stage) -> tuple:
    mine, _, _, _, nk = stage
    return nk, len(mine) - nk, tuple(mine[0].shape)


def _hold_stage_merge(name, stage):
    """A merge-split stage of the megablock (``stage_merge``: one split pass
    and one merge launch, no K1 or K2) against ``stage_merge_ref`` and
    against the same stage as one K2 merge level, bit for bit."""
    import torch

    from archon_tpu_torch.ops import sort as S

    mine, partner, rows, keep_low, nk = stage
    S.sort_tiles.launches = S.merge_level.launches = 0
    calls = S.stage_merge.launches
    got = S.stage_merge(mine, partner, rows, keep_low, nk)
    k1, k2, st = S.sort_tiles.launches, S.merge_level.launches, S.stage_merge.launches - calls
    e1 = max(_max_err(g, x) for g, x in zip(got, S.stage_merge_ref(mine, partner, rows, keep_low, nk)))
    e2 = max(_max_err(g, x) for g, x in zip(got, _merge_level_stage(mine, partner, rows, keep_low, nk)))
    torch.cuda.synchronize()
    KERNEL_ERR["stage_merge"] = max(KERNEL_ERR["stage_merge"], e1, e2)
    B, w = mine[0].shape
    print(f"[megablock] {name}: ({B}, {w}) rows, keys={nk} payloads={len(mine) - nk}, partner rows "
          f"{rows}, keep_low {keep_low.view(-1).tolist()}: launches stage_merge {st}, K1 {k1}, K2 "
          f"{k2}; against stage_merge_ref {e1}, against the stage as one K2 level {e2}")
    if e1 or e2 or (st, k1, k2) != (1, 0, 0):
        raise AssertionError(f"the stage merge disagrees or launched otherwise: {name}")


def _device_and_enqueue_ms(fn):
    """``fn()`` once: (result, device ms by CUDA events, the host's ms to
    enqueue it).  A host read inside ``fn`` shows in both."""
    import torch

    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop), enqueue


def phase_megablock(text: bytes):
    """The sharded megablock, 8 shards in process on the card; returns the
    launches of the 64 MiB ``encode_megablock`` and the kernels' ms and
    bounds at its shapes."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core.fast2 import bwt_v3
    from archon_tpu_torch.ops import sort as S
    from archon_tpu_torch.parallel import megablock as mb
    from archon_tpu_torch.parallel import megapipe
    from archon_tpu_torch.parallel.blocks import make_mesh
    from archon_tpu_torch.parallel.collectives import collectives
    from archon_tpu_torch.utils.corpus import gauntlet_cases

    ns = 8
    mesh = make_mesh({"sp": ns}, devices=["cuda"] * ns)
    coll = collectives(mesh, "sp")

    def sorts_of(data):
        run = lambda: mb.bwt_megablock(data, mesh, "small")
        return _captured_sorts((mb,), run, attr="sort_rows"), _captured_stages(run)

    # ---- one 4 MiB text block, S = 512 KiB: every sort shape against its twins
    block = np.frombuffer(text[: 4 * MIB][::-1], np.uint8)
    arr = torch.from_numpy(block.copy()).cuda()
    local, stages = sorts_of(block)
    Sb = len(block) // ns
    want_shapes = sorted((nk, npl, (ns, Sb)) for nk, npl in ((5, 0), (2, 0), (1, 1)))
    shapes = (sorted((len(k), len(pl), tuple(k[0].shape)) for k, pl in local),
              sorted(map(_stage_shape, stages)))
    if shapes != (want_shapes, want_shapes):
        raise AssertionError(f"the megablock's sorts have other shapes than expected: {shapes}")
    for keys, payloads in local:
        _hold_rows_sort(f"4 MiB block, local sort, {len(keys)} keys", keys, payloads)
    for stage in stages:
        _hold_stage_merge(f"4 MiB block, stage, {stage[4]} keys", stage)
    for (keys, payloads), stage in zip(local, stages):
        ms = _time_ms(lambda: S.sort_rows(keys, payloads))
        chain = _time_ms(lambda: S.sort_rows_ref(keys, payloads))
        one = _time_ms(lambda: S.stage_merge(*stage))
        level = _time_ms(lambda: _merge_level_stage(*stage))
        schain = _time_ms(lambda: S.stage_merge_ref(*stage))
        print(f"[megablock] 4 MiB block, {len(keys)} keys + {len(payloads)} payloads: local "
              f"sort_rows ({ns}, {Sb}) {ms:.3f} ms (torch.sort chain {chain:.3f}); a stage of "
              f"({ns}, {Sb}) rows as stage_merge {one:.3f} ms, as one K2 merge level {level:.3f} "
              f"(stage_merge_ref, the torch.sort chain, {schain:.3f})")
    del local, stages

    # ---- a ragged shard size: 10^6 B, S = 125,000 (S mod 2048 = 72): each row's last tile masked
    ragged = np.frombuffer(text[:1_000_000], np.uint8)
    for stage in _captured_stages(lambda: mb.bwt_megablock(ragged, mesh, "small")):
        _hold_stage_merge(f"10^6 B block, stage, {stage[4]} keys", stage)

    want, v3_ms, _ = _block_call("megablock", "4 MiB text block, bwt_v3 (for comparison)",
                                 lambda: bwt_v3(arr, "small"))
    mb.stats.reset()
    (L, base), _, launches4 = _counted("bwt_megablock 4 MiB",
                                       lambda: mb.bwt_megablock(block, mesh, "small"))
    rounds4, syncs4 = mb.stats.rounds, mb.stats.host_syncs
    stages4 = (mb.stats.stages, mb.stats.stage_kernel)
    if stages4[0] != stages4[1] or not stages4[0]:
        raise AssertionError(f"a stage of the 4 MiB megablock missed the stage kernels: {stages4}")
    _same_bwt("bwt_megablock, 4 MiB text block", (L.reshape(-1), base), want)
    mega_ms = _events_ms(lambda: mb.bwt_megablock(block, mesh, "small"), 3)
    real_stage = mb.stage_merge
    mb.stage_merge = _merge_level_stage
    try:
        got = mb.bwt_megablock(block, mesh, "small")
        level_ms = _events_ms(lambda: mb.bwt_megablock(block, mesh, "small"), 3)
    finally:
        mb.stage_merge = real_stage
    _same_bwt("bwt_megablock with every stage one K2 level", (got[0].reshape(-1), got[1]), want)
    print(f"[megablock] 4 MiB text block, ns {ns}: bwt_megablock {mega_ms:.3f} ms = "
          f"{mega_ms / v3_ms:.1f}x bwt_v3's {v3_ms:.3f} (CUDA events, incl. the copy to the card "
          f"and the host reads); rounds {rounds4}, host reads {syncs4}, launches {launches4}, "
          f"stages {stages4[0]}, all through stage_merge; (L, base) == bwt_v3's; with every stage "
          f"as one K2 merge level (the form stage_merge replaced) {level_ms:.3f} ms, the same "
          f"(L, base)")

    # ---- Gauntlet: the tie group that spans every shard
    for name in ("zeros", "fibonacci"):
        g = np.frombuffer(gauntlet_cases(MIB)[name][:MIB], np.uint8)
        mb.stats.reset()
        (L, base), dt, launches = _counted(f"bwt_megablock {name}",
                                           lambda: mb.bwt_megablock(g, mesh, "small"))
        _same_bwt(f"bwt_megablock on Gauntlet {name}", (L.reshape(-1), base),
                  bwt_v3(torch.from_numpy(g.copy()).cuda(), "small"))
        print(f"[megablock] Gauntlet {name} 2^20, ns {ns}: {dt * 1e3:.3f} ms (host clock), rounds "
              f"{mb.stats.rounds}, launches {launches}; (L, base) == bwt_v3's")

    # ---- 64 MiB as ONE megablock, S = 8 MiB: the pieces apart, by hand
    n = len(text)
    Sm = n // ns
    view = np.frombuffer(text, np.uint8)[::-1]
    data_dev = coll.shard(torch.from_numpy(view.copy()))
    torch.cuda.reset_peak_memory_stats()
    (rank, na), init_ms, init_host = _device_and_enqueue_ms(
        lambda: mb._make_init(mesh, Sm, n, "small")(data_dev))
    round_fn = mb._make_round_dyn(mesh, Sm, n, "small")
    k, per_round = 3, []
    while int(na) != 0:
        (rank, na), ms, host = _device_and_enqueue_ms(lambda: round_fn(rank, k))
        per_round.append((k, ms, host, int(na)))
        k *= 4
    (L_dev, base), emit_ms, _ = _device_and_enqueue_ms(
        lambda: mb._make_emit(mesh, Sm, n)(rank, data_dev))
    hist, hist_ms, _ = _device_and_enqueue_ms(lambda: megapipe._make_hist(mesh)(L_dev))
    values, lengths = megapipe._codes_arrays(megapipe.build_encoder_var(hist.cpu().numpy()))
    max_len = max(int(lengths.max()), 1)
    vals_dev = torch.from_numpy(values.astype(np.int64)).cuda()
    lens_dev = torch.from_numpy(lengths).cuda()
    _, pack_ms, _ = _device_and_enqueue_ms(
        lambda: megapipe._make_pack(mesh, max_len)(L_dev, vals_dev, lens_dev))
    print(f"[megablock] 64 MiB as one megablock, ns {ns}, S {Sm}, by hand (device ms by CUDA "
          f"events / host ms to enqueue): init {init_ms:.3f} / {init_host:.3f}; rounds "
          + "; ".join(f"k={k} {ms:.3f} / {host:.3f} (nactive {na})" for k, ms, host, na in per_round)
          + f"; emit {emit_ms:.3f}; hist {hist_ms:.3f}; pack (max code length {max_len}) "
          f"{pack_ms:.3f}; peak device memory {torch.cuda.max_memory_allocated() / MIB:.0f} MiB")
    del rank, L_dev, data_dev

    # ---- the same through the entry points
    torch.cuda.reset_peak_memory_stats()
    mb.stats.reset()
    blob, enc_dt, launches = _counted(
        "encode_megablock 64 MiB", lambda: megapipe.encode_megablock(text, mesh, "a4", "var"))
    rounds, syncs = mb.stats.rounds, mb.stats.host_syncs
    launches["stage_merge"] = mb.stats.stage_kernel
    if mb.stats.stage_kernel != mb.stats.stages:
        raise AssertionError(f"a stage of the 64 MiB megablock missed the stage kernels: "
                             f"{mb.stats.stage_kernel} of {mb.stats.stages}")
    peak = torch.cuda.max_memory_allocated() / MIB
    t0 = time.perf_counter()
    back = megapipe.decode_megablock(blob)
    dec_dt = time.perf_counter() - t0
    if back != text:
        raise AssertionError("decode_megablock does not give the 64 MiB back")
    if struct.unpack("<BBHQII", blob[4:24]) != (0, 1, ns, n, int(base), 0):
        raise AssertionError("the ATM1 header differs from the run by hand")
    packed = port.encode_file(text, "a4", 4 * MIB, pack=True, impl="micro", device="cuda")
    print(f"[megablock] encode_megablock a4 var, 64 MiB, ns {ns}: {enc_dt:.4f} s = "
          f"{n / 1e6 / enc_dt:.2f} MB/s (host clock); rounds {rounds}, host "
          f"reads {syncs}, launches {launches} (stage_merge: one a stage), peak device memory {peak:.0f} MiB = "
          f"{peak * MIB / n:.0f} B per input byte; decode_megablock {dec_dt:.4f} s, round trip ok; "
          f"ATM1 {len(blob)} bytes against ATA2 (4 MiB blocks) {len(packed)}: "
          f"{len(blob) / len(packed):.2f}x")

    # ---- the 64 MiB run's sort shapes against their twins, whole sorts
    local, stages = sorts_of(view)
    for keys, payloads in local:
        _hold_rows_sort(f"64 MiB megablock, local sort, {len(keys)} keys", keys, payloads,
                        levels=False)
    for stage in stages:
        _hold_stage_merge(f"64 MiB megablock, stage, {stage[4]} keys", stage)
    keys5 = next(k for k, _ in local if len(k) == 5)
    stage5 = next(st for st in stages if st[4] == 5)
    stage1 = next(st for st in stages if st[4] == 1)  # the route-back: 1 key + an int32 payload
    del local, stages
    mat = torch.stack(keys5).view(5, n)
    k1_ms = _time_ms(lambda: S.sort_tiles(mat))
    tuples = S.sort_tiles(mat)
    first_ms = _time_ms(lambda: S.merge_level(mat, tuples, S.TILE))
    del mat, tuples, keys5
    stage_ms = _time_ms(lambda: S.stage_merge(*stage5))
    stage1_ms = _time_ms(lambda: S.stage_merge(*stage1))
    level_ms = _time_ms(lambda: _merge_level_stage(*stage5))
    del stage5, stage1
    b1 = kernel_bounds(n, 5, 4, S.TILE, n)
    b5, b1p = stage_bound_ms(n, 5, 0), stage_bound_ms(n, 1, 4)
    print(f"[megablock] kernels at the 64 MiB shapes, 5 keys (4 carried) + index: K1 over "
          f"({ns}, {Sm}) {k1_ms:.3f} ms (bound {b1['sort_tiles']['bound_ms']:.3f}); one K2 level "
          f"there {first_ms:.3f} (bound {b1['merge_level']['bound_ms']:.3f}); a stage of "
          f"({ns}, {Sm}) rows by stage_merge: 5 keys {stage_ms:.3f} (bound {b5:.3f}; as one K2 "
          f"merge level {level_ms:.3f}), 1 key + int32 {stage1_ms:.3f} (bound {b1p:.3f})")
    shapes = {"sort_tiles": {"ms_megablock": k1_ms,
                             "bound_ms_megablock": b1["sort_tiles"]["bound_ms"]},
              "merge_level": {"ms_megablock": first_ms,
                              "bound_ms_megablock": b1["merge_level"]["bound_ms"]},
              "stage_merge": {"ms_megablock": stage_ms, "bound_ms_megablock": b5,
                              "ms_megablock_1key_int32": stage1_ms,
                              "bound_ms_megablock_1key_int32": b1p,
                              "ms_megablock_as_k2_level": level_ms}}
    return launches, launches4, shapes


def phase_rows_inverse_and_certificate(text: bytes) -> None:
    """``unbwt_blocks`` with all rows in one walk against the row loop, and
    ``formats.encode`` by the device certificate, on and off."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core import batched, unbwt
    from archon_tpu_torch.parallel import blocks as pblocks

    block = 4 * MIB
    rows = torch.from_numpy(np.frombuffer(text[: 8 * block], np.uint8).reshape(8, block).copy())
    rows = rows.cuda().flip(1)
    L, base = batched.bwt_batched_v3(rows, "small")
    got, rows_ms = _timed(lambda: pblocks.unbwt_blocks(L, base, "small"), calls=2)
    bases = base.tolist()
    loop, loop_ms = _timed(lambda: torch.stack(
        [unbwt.bwt_inverse(L[b], bases[b], "small") for b in range(8)]), calls=1)
    if not (torch.equal(got, loop) and torch.equal(got, rows.flip(1))):
        raise AssertionError("unbwt_blocks differs from the row loop or from the blocks")
    print(f"[batched] unbwt_blocks (8, {block}): all rows in one lockstep walk {rows_ms:.3f} ms, "
          f"row by row through bwt_inverse {loop_ms:.3f} ms (CUDA events); equal, and the blocks")
    one = text[:block]
    want, on_ms = _timed(lambda: port.encode(one, "a4", device="cuda"), calls=3)
    off, off_ms = _timed(lambda: port.encode(one, "a4", verify=False, device="cuda"), calls=3)
    L_ref, base_ref = bwt_reference(one, "a4")
    if not want == off == L_ref.tobytes() + np.uint32(base_ref).tobytes():
        raise AssertionError("formats.encode differs from the reference BWT")
    print(f"[batched] formats.encode of {block} bytes, a4: verify on (bwt_batched_v3_certified on "
          f"one row) {on_ms:.3f} ms, off {off_ms:.3f} ms (CUDA events, incl. the copies); == the "
          f"reference BWT")


def phase_cli(text: bytes) -> None:
    """``python -m archon_tpu_torch e --impl it2 --profile-dir`` and ``d`` in
    subprocesses on a 16 MiB file, then ``e --sp 8`` and ``d`` of its blob."""
    import shutil

    from archon_tpu_torch.ops._build import BUILD_DIR

    work = BUILD_DIR / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        src, out, back, prof = work / "in", work / "out.ata", work / "back", work / "prof"
        src.write_bytes(text[: 16 * MIB])
        cmd = [sys.executable, "-m", "archon_tpu_torch"]
        t0 = time.perf_counter()
        enc = subprocess.run([*cmd, "--profile-dir", str(prof), "e", str(src), str(out),
                              "--impl", "it2"], cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        enc_dt = time.perf_counter() - t0
        if enc.returncode != 0:
            raise AssertionError(f"the command line's encode failed: {enc.stderr[-2000:]}")
        report = [ln for ln in enc.stdout.splitlines() if ln.strip()]
        heads = [ln.split(":")[0] for ln in report[-5:]]
        if heads != ["Read time", "Transform time", "Write time", "Total time", "Linear coef"]:
            raise AssertionError(f"the command line printed no stage report: {report[-6:]}")
        traces = [p for p in prof.iterdir() if p.stat().st_size > 0] if prof.is_dir() else []
        if not traces:
            raise AssertionError("--profile-dir left no trace file")
        dec = subprocess.run([*cmd, "d", str(out), str(back)], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        if dec.returncode != 0 or back.read_bytes() != text[: 16 * MIB]:
            raise AssertionError(f"the command line's decode failed: {dec.stderr[-2000:]}")
        print(f"[cli] e --impl it2 --profile-dir on {16 * MIB} bytes: {enc_dt:.2f} s for the "
              f"process; report: {' | '.join(report[-5:])}; trace {traces[0].name} "
              f"{traces[0].stat().st_size} bytes; d gives the input back")
        t0 = time.perf_counter()
        enc = subprocess.run([*cmd, "e", str(src), str(out), "--sp", "8"], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        enc_dt = time.perf_counter() - t0
        if enc.returncode != 0 or "8 shards on 1 device (cuda)" not in enc.stdout:
            raise AssertionError(f"the command line's e --sp 8 failed: {enc.stderr[-2000:]}")
        size = out.stat().st_size
        if out.read_bytes()[:4] != b"ATM1":
            raise AssertionError("e --sp 8 wrote no ATM1 container")
        back.unlink()
        dec = subprocess.run([*cmd, "d", str(out), str(back)], cwd=ROOT, capture_output=True,
                             text=True, timeout=600)
        if dec.returncode != 0 or back.read_bytes() != text[: 16 * MIB]:
            raise AssertionError(f"the command line's d of the ATM1 file failed: {dec.stderr[-2000:]}")
        report = [ln for ln in enc.stdout.splitlines() if ln.strip()]
        print(f"[cli] e --sp 8 on {16 * MIB} bytes: {enc_dt:.2f} s for the process, ATM1 of "
              f"{size} bytes; report: {' | '.join(report[-5:])}; d gives the input back")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_memory(text: bytes) -> None:
    """``memory_report`` beside the measured peak of one ``bwt_v3``."""
    import torch

    from archon_tpu_torch.core.fast2 import bwt_v3
    from archon_tpu_torch.utils.tools import memory_report

    arr = _reversed_block(text[: 4 * MIB])
    n = arr.shape[0]
    bwt_v3(arr, "small")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwt_v3(arr, "small")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held + n  # the input is part of the report
    rep = memory_report(n, "v3")
    print(f"[memory] bwt_v3 at n={n}: memory_report {rep['bytes_per_input_byte']:.0f} B per input "
          f"byte = {rep['total_bytes'] / MIB:.1f} MiB; measured peak above what was held before "
          f"the call, plus the input: {peak / MIB:.1f} MiB = {peak / n:.1f} B per input byte "
          f"(torch.cuda.max_memory_allocated)")
    if not 0.85 < peak / rep["total_bytes"] < 1.15:
        raise AssertionError("memory_report is off the measured peak by more than 15%")


def main() -> int:
    if not (ROOT / "archon_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (package not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    def timed_phase(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    phase_card()
    timed_phase(phase_build)
    stats = timed_phase(phase_kernels)
    launches, text, stream = timed_phase(phase_main)
    timed_phase(phase_a6, text[: 16 * MIB])
    timed_phase(phase_inverse, text[: 16 * MIB])
    timed_phase(phase_breakdown, text[: 4 * MIB])
    timed_phase(phase_sort_rows)
    batched_launches = timed_phase(phase_batched, text, stream)
    pack_stats, pack_kernels = timed_phase(phase_pack, text)
    timed_phase(phase_resume, text, stream)
    fast_block = timed_phase(phase_v1, text)
    sais_block = timed_phase(phase_sais, text)
    it2_launches, it2_block = timed_phase(phase_it2, text, stream)
    mega_launches, mega_block, mega_shapes = timed_phase(phase_megablock, text)
    timed_phase(phase_rows_inverse_and_certificate, text)
    timed_phase(phase_cli, text)
    timed_phase(phase_memory, text)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": (launches[name] + batched_launches[name] + it2_launches[name]
                      + mega_launches[name]),
         "launches_stream": launches[name], "launches_batched": batched_launches[name],
         "launches_it2": it2_launches[name], "launches_megablock": mega_launches[name],
         "launches_megablock_4mib": mega_block[name], "launches_it2_block": it2_block[name],
         "launches_sais_block": sais_block[name], "launches_fast_block": fast_block[name],
         "max_abs_err": KERNEL_ERR[name], **stats[name], **mega_shapes[name]}
        for name in ("sort_tiles", "merge_level")
    ] + [{"name": "stage_merge", "route": "cuda", "source": SOURCE, "replaces": None,
          "launches_megablock": mega_launches["stage_merge"],
          "max_abs_err": KERNEL_ERR["stage_merge"], **mega_shapes["stage_merge"]}] + pack_kernels
    print(json.dumps({"kernels": kernels, "pack": pack_stats}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
