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
   rank keys); timed (K1, all K2 levels of one sort, the whole
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
10. resume: ``encode_to_path`` cut in the middle of a frame and resumed, then
    resumed after one input byte changed; ``extract_block`` of both
    containers;
11. one JSON line describing the kernels, then the device line last.

Phases 5 and 6 zero the kernel launch counts before each encode or device
decode and fail unless both kernels launched in it; so do the stream's and
the batched path's 64 MiB runs, whose counts the JSON line reports.

The script uses the port's own API only; its test data and its BWT
reference are made here, from fixed seeds.
"""

from __future__ import annotations

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


def _time_ms(fn):
    """Mean milliseconds of ``fn`` over ``TIMED_CALLS`` calls after one warm-up
    call, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / TIMED_CALLS


def _max_err(got, want) -> int:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def phase_kernels():
    """Every kernel against its twin on the card; returns per-kernel stats."""
    import numpy as np
    import torch

    from archon_tpu_torch.ops import sort as S

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    err = {"sort_tiles": 0, "merge_level": 0}

    def keyset(n, count, hi):
        return [torch.from_numpy(rng.integers(-1, hi, n).astype(np.int32)).to(dev)
                for _ in range(count)]

    def check(name, keys, payloads):
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
        print(f"[kernels] {name}: n={keys[0].shape[0]} keys={len(keys)}+index "
              f"payloads={len(payloads)} tile_err={e1} merge_err={e2} sort_err={e3} {status}")
        if status != "ok":
            raise AssertionError(f"kernel disagrees with its plain twin: {name}")

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
    text_sorts = _text_block_sorts(synthetic_text(4 * MIB, seed=7), dev)
    for label, (keys, payloads) in text_sorts.items():
        check(f"4 MiB text block, {label}", keys, payloads)

    # timing: the full round's shape at random keys, the two real sorts of
    # one text block, and 1 key + index at 2^24
    rows = {"random keys (n/64 distinct), 2^22": (main_keys, [iota, prev]), **{
        f"text block {label}, 2^22": sorts for label, sorts in text_sorts.items()},
        "1 key 0..255 + index, 2^24": (big_keys, big_pay)}
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
    return {"sort_tiles": {"max_abs_err": err["sort_tiles"], "ms": t["k1"],
                           "plain_ms": t["k1_plain"], **bounds["sort_tiles"],
                           "library_ms": None, **whole},
            "merge_level": {"max_abs_err": err["merge_level"], "ms": t["last"],
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


def _text_block_sorts(block: bytes, dev) -> dict:
    """The full-width sorts ``bwt_v3`` runs on one text block, as the main
    path gives them (the block reversed, a4): the bootstrap's four
    packed-trigram keys and each full round's four rank keys, with the index
    and the previous byte as payloads.  Captured at ``fast2._sort_ctx``."""
    import numpy as np
    import torch

    from archon_tpu_torch.core import fast2

    seen = []
    sort_ctx = fast2._sort_ctx

    def capture(keys, iota, payloads):
        seen.append((list(keys), [iota, *payloads]))
        return sort_ctx(keys, iota, payloads)

    fast2._sort_ctx = capture
    try:
        fast2.bwt_v3(torch.from_numpy(np.frombuffer(block[::-1], np.uint8).copy()).to(dev), "small")
    finally:
        fast2._sort_ctx = sort_ctx
    if len(seen) < 2:
        raise AssertionError(f"bwt_v3 ran {len(seen)} full-width sorts on a text block, not 2+")
    return {("bootstrap trigram keys" if i == 0 else f"full round {i} rank keys"): s
            for i, s in enumerate(seen)}


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


def bwt_reference(block: bytes, generation: str):
    """(L, base) of the a4 (end-of-string smallest) or a7 (largest) BWT of
    the REVERSED block, the frame convention, by plain prefix doubling."""
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
    print(f"[{'main' if impl == 'stream' else 'batched'}] {label}: {len(data)} bytes in {dt:.4f} s "
          f"= {len(data) / 1e6 / dt:.2f} MB/s (encode_file, impl {impl}, verify "
          f"{'on' if verify else 'off'}); round trip ok; block 0 == reference BWT"
          + ("; == stream container" if same_as is not None else ""))
    return dt, blob


def phase_main():
    """The port's stream path; returns the kernel launch counts of the 64 MiB
    run, the text, and the stream's containers and seconds by run."""
    from archon_tpu_torch.core import fast2
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
    orig_micro, orig_cascade = fast2._micro_round, fast2._narrow_cascade

    def micro(*a, **kw):
        seen["micro"] += 1
        return orig_micro(*a, **kw)

    def cascade(*a, **kw):
        seen["cascade"] += 1
        return orig_cascade(*a, **kw)

    fast2._micro_round, fast2._narrow_cascade = micro, cascade
    try:
        _encode_checked("a4 1 MiB planted repeat", block, "a4", MIB)
    finally:
        fast2._micro_round, fast2._narrow_cascade = orig_micro, orig_cascade
    print(f"[main] planted repeat took micro rounds {seen['micro']}, cascade {seen['cascade']}")
    if not (seen["micro"] and seen["cascade"]):
        raise AssertionError(f"planted repeat missed the micro tail or the cascade: {seen}")
    return launches, data, stream


def planted_repeat_block() -> bytes:
    """1 MiB of random bits with a 1900-byte repeat planted twice (the shape
    of tests/test_fast2.py's micro-tail cases): about 3800 actives tied past
    the micro tail's reach."""
    import numpy as np

    rng = np.random.default_rng(13)
    block = rng.integers(0, 2, MIB, dtype=np.uint8)
    rep = rng.integers(0, 2, 1900, dtype=np.uint8)
    block[1000:2900] = rep
    block[MIB // 2 : MIB // 2 + 1900] = rep
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

    def check(name, keys, payloads):
        S.sort_tiles.launches = S.merge_level.launches = 0
        got = S.sort_rows(keys, payloads)
        k1, k2 = S.sort_tiles.launches, S.merge_level.launches
        want = S.sort_rows_ref(keys, payloads)
        e = max(_max_err(g, w) for g, w in zip(got, want))
        torch.cuda.synchronize()
        B, n = keys[0].shape
        print(f"[sort_rows] {name}: ({B}, {n}) keys={len(keys)} payloads={len(payloads)} "
              f"row width {S.row_width(B, n)}; launches K1 {k1}, K2 {k2}; max_abs_err {e} "
              f"{'ok' if e == 0 else 'MISMATCH'}")
        if e or k1 != 1 or k2 != (S.row_width(B, n) // S.TILE - 1).bit_length():
            raise AssertionError(f"sort_rows disagrees with its plain twin or its launches: {name}")

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
    for pipe in (1, 2, 4, 8, 16):
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
    L, base, rank = batched._bwt_batched_v3_impl(data2, "small", want_rank=True)
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


def main() -> int:
    if not (ROOT / "archon_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (package not found)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    phase_card()
    phase_build()
    stats = phase_kernels()
    launches, text, stream = phase_main()
    phase_a6(text[: 16 * MIB])
    phase_inverse(text[: 16 * MIB])
    phase_breakdown(text[: 4 * MIB])
    phase_sort_rows()
    batched_launches = phase_batched(text, stream)
    phase_resume(text, stream)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name] + batched_launches[name],
         "launches_stream": launches[name], "launches_batched": batched_launches[name],
         **stats[name]}
        for name in ("sort_tiles", "merge_level")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
