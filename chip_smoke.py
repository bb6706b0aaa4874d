#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (archon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printing its own lines; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the CUDA kernels from ``archon_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin on the card, exact equality, at
   the shapes the forward BWT gives it, and both timed at 2^22 x 6 operands;
4. the main path through ``archon_tpu_torch.encode_file``: 64 MiB of
   synthetic text in 4 MiB blocks (a4), verify on and off, and 16 MiB (a7),
   each decoded back with ``decode_file``, block 0 held against a plain numpy
   BWT (prefix doubling, below); one 1 MiB planted-repeat block through the
   micro tail and the narrowed cascade.  Kernel launch counts are zeroed just
   before the 64 MiB verify-on run and read just after it;
5. where a block's time goes: ``bwt_v3`` on one 4 MiB text block (CUDA
   events), the host LF walk of one block (``decode_file``), and
   ``torch.profiler``'s self device time per op over one ``bwt_v3``, with the
   device busy share of that call;
6. one JSON line describing the kernels, then the device line last.

The script uses the port's own API only; its test data and its BWT
reference are made here, from fixed seeds.
"""

from __future__ import annotations

import json
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
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build] {line.strip()}")
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
        perm = S.sort_tiles(mat)
        e1 = _max_err(perm, S.sort_tiles_ref(mat))
        run, e2 = S.TILE, 0
        while run < perm.shape[0]:
            nxt = S.merge_level(mat, perm, run)
            e2 = max(e2, _max_err(nxt, S.merge_level_ref(mat, perm, run)))
            perm, run = nxt, run * 2
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
    check("ragged n = 2^22 - 17", keyset(n - 17, 2, 1000), keyset(n - 17, 1, 1 << 30))
    check("n = 1", keyset(1, 3, 5), keyset(1, 1, 5))
    edge = keyset(100_003, 2, 3)
    for k in edge:
        k[k == 1] = 0x7FFFFFFF
    check("keys of -1 and 0x7FFFFFFF", edge, [])
    check("all-equal keys", [torch.zeros(300_001, dtype=torch.int32, device=dev)] * 2, [])

    # timing at the full round's shape: 4 keys + index, iota and prev payloads
    mat = torch.stack(main_keys)
    perm = S.sort_tiles(mat)
    run = S.TILE
    while run * 2 < perm.shape[0]:
        perm = S.merge_level(mat, perm, run)
        run *= 2
    t = {
        "sort_tiles": (_time_ms(lambda: S.sort_tiles(mat)), _time_ms(lambda: S.sort_tiles_ref(mat))),
        "merge_level": (_time_ms(lambda: S.merge_level(mat, perm, run)),
                        _time_ms(lambda: S.merge_level_ref(mat, perm, run))),
    }
    sort_ms = _time_ms(lambda: S.sort_operands(main_keys, [iota, prev]))
    plain_ms = _time_ms(lambda: S.sort_operands_ref(main_keys, [iota, prev]))
    print(f"[timing] n=2^22, 4 keys + index, payloads iota+prev: "
          f"sort_tiles {t['sort_tiles'][0]:.3f} ms (plain {t['sort_tiles'][1]:.3f}); "
          f"merge_level run={run} {t['merge_level'][0]:.3f} ms (plain {t['merge_level'][1]:.3f}); "
          f"sort_operands {sort_ms:.3f} ms (plain torch.sort passes {plain_ms:.3f})")
    return {name: {"max_abs_err": err[name], "ms": t[name][0], "plain_ms": t[name][1]}
            for name in err}


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


def _encode_checked(label, data, generation, block_size, verify=True):
    import numpy as np
    import torch

    import archon_tpu_torch as port

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = port.encode_file(data, generation, block_size, verify=verify, device="cuda")
    dt = time.perf_counter() - t0
    if port.decode_file(blob) != data:
        raise AssertionError(f"{label}: decode_file does not give the input back")
    L, base = _frame0(blob)
    want_L, want_base = bwt_reference(data[:block_size], generation)
    if not (np.array_equal(L, want_L) and base == want_base):
        raise AssertionError(f"{label}: block 0 differs from the reference BWT")
    print(f"[main] {label}: {len(data)} bytes in {dt:.4f} s = {len(data) / 1e6 / dt:.2f} MB/s "
          f"(encode_file, verify {'on' if verify else 'off'}); round trip ok; "
          f"block 0 == reference BWT")
    return dt


def phase_main():
    """The port's main path; returns the kernel launch counts of the 64 MiB run."""
    import numpy as np

    from archon_tpu_torch.core import fast2
    from archon_tpu_torch.ops import sort as S

    data = synthetic_text(64 * MIB, seed=7)
    print(f"[main] synthetic text, {len(data)} bytes")
    # untimed warm-up: the first call loads torch's CUDA modules for the ops
    _encode_checked("warm-up, a4 4 MiB (not a measurement)", data[: 4 * MIB], "a4", 4 * MIB)
    S.sort_tiles.launches = S.merge_level.launches = 0
    _encode_checked("a4 64 MiB / 4 MiB blocks", data, "a4", 4 * MIB)
    launches = {"sort_tiles": S.sort_tiles.launches, "merge_level": S.merge_level.launches}
    print(f"[main] kernel launches in the a4 64 MiB run: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    _encode_checked("a4 64 MiB / 4 MiB blocks", data, "a4", 4 * MIB, verify=False)
    before = S.sort_tiles.launches + S.merge_level.launches
    _encode_checked("a7 16 MiB / 4 MiB blocks", data[: 16 * MIB], "a7", 4 * MIB)
    if S.sort_tiles.launches + S.merge_level.launches <= before:
        raise AssertionError("the a7 run launched no kernel")

    # planted repeat (the shape of tests/test_fast2.py's micro-tail cases):
    # ~3800 actives tied past the micro tail's reach -> micro, then cascade
    rng = np.random.default_rng(13)
    block = rng.integers(0, 2, MIB, dtype=np.uint8)
    rep = rng.integers(0, 2, 1900, dtype=np.uint8)
    block[1000:2900] = rep
    block[MIB // 2 : MIB // 2 + 1900] = rep
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
        _encode_checked("a4 1 MiB planted repeat", block.tobytes(), "a4", MIB)
    finally:
        fast2._micro_round, fast2._narrow_cascade = orig_micro, orig_cascade
    print(f"[main] planted repeat took micro rounds {seen['micro']}, cascade {seen['cascade']}")
    if not (seen["micro"] and seen["cascade"]):
        raise AssertionError(f"planted repeat missed the micro tail or the cascade: {seen}")
    return launches, data[: 4 * MIB]


def phase_breakdown(block: bytes) -> None:
    """Where one 4 MiB block's time goes: the device transform, the host walk."""
    import numpy as np
    import torch

    import archon_tpu_torch as port
    from archon_tpu_torch.core.fast2 import bwt_v3

    arr = torch.from_numpy(np.frombuffer(block[::-1], np.uint8).copy()).cuda()
    bwt_ms = _time_ms(lambda: bwt_v3(arr, "small"))
    blob = port.encode_file(block, "a4", len(block), verify=False, device="cuda")
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
    launches, block0 = phase_main()
    phase_breakdown(block0)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], **stats[name]}
        for name in ("sort_tiles", "merge_level")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
