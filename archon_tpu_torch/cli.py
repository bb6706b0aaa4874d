"""Command-line interface of the PyTorch/CUDA port (argument names as in
``archon_tpu/cli.py``):

  python -m archon_tpu_torch [--profile-dir DIR] <command> ...

  python -m archon_tpu_torch a4|a7 e|d <in> <out> [--no-verify] [--device D]
                                        # a4/a7-compatible single block; d walks
                                        # on the host unless --device is given
  python -m archon_tpu_torch a6 <in> <out> [-c byte|fix|var] [-r N]
                                [-o none|freq|greedy|topo|bubble] [-u] [--device D]
                                        # a6-compatible format
  python -m archon_tpu_torch e|d <in> <out> [-g a4|a7] [-b BLOCK] [--pack]
                                [--impl micro|v3|stream|it2] [--resume]
                                [--no-verify] [--dp N] [--sp N] [--device D]
                                        # block-streamed ATA1/ATA2 container,
                                        # or with --sp one sharded megablock (ATM1);
                                        # d reads all three

Every command prints the a4/a5-style stage report (Read / Transform / Write /
Total time and the "Linear coef" in ms/MB).  ``--profile-dir`` (or
``ARCHON_PROFILE_DIR``) writes a ``torch.profiler`` trace of the transform
stage there.

``--dp N`` splits each batch of blocks over N devices: with ``--device cuda``
the first N cards (it raises, naming the count, where there are fewer), with
``--device cpu`` N entries of the CPU.  ``--sp N`` encodes the input as ONE
megablock in N shards (``parallel.megapipe``, coder ``var``); N goes into the
``ATM1`` header and the bytes depend on it, not on the devices: with a card
for every shard each shard runs in a process of its own on its card
(``torch.distributed``, NCCL), otherwise all N shards lie on the one device
asked for, and a printed line says which it was.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

from .config import ArchonConfig


def _rw_timed(args, fn, profile_dir=None):
    """Read-transform-write with the a4/a5-style per-stage report
    (a5/src/archon.c:161-192 "Stage k" + "Linear coef" ms/MB)."""
    from .utils.timing import StageTimer, profile_trace

    timer = StageTimer()
    with timer.stage("Read"):
        with open(args.infile, "rb") as f:
            data = f.read()
    timer.total_bytes = len(data)
    with timer.stage("Transform"):
        with profile_trace(profile_dir):
            out = fn(data)
    with timer.stage("Write"):
        with open(args.outfile, "wb") as f:
            f.write(out)
    print(f"{len(data)} -> {len(out)} bytes")
    timer.report()


def _encode_sharded(data: bytes, sp: int, generation: str, device) -> bytes:
    """``e --sp N``: ``data`` as one ATM1 megablock of ``sp`` shards.  With a
    CUDA card for every shard, one process a card (NCCL); otherwise every
    shard on ``device``.  Prints how the shards were laid out."""
    import torch

    from .io.blocks import as_device
    from .parallel import megapipe
    from .parallel.blocks import make_mesh
    from .parallel.collectives import spawn

    dev = as_device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() >= sp:
        print(f"{sp} shards on {sp} devices (one process a card)")
        return spawn(megapipe._encode_on_rank, sp, "nccl", data, "cuda", generation, "var")
    print(f"{sp} shards on 1 device ({dev})")
    mesh = make_mesh({"sp": sp}, devices=[dev] * sp)
    return megapipe.encode_megablock(data, mesh, generation)


def _parser():
    p = argparse.ArgumentParser(prog="python -m archon_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the transform stage here "
                   "(also honors ARCHON_PROFILE_DIR)")
    sub = p.add_subparsers(dest="cmd", required=True)
    for gen in ("a4", "a7"):
        g = sub.add_parser(gen, help=f"{gen}-compatible single-block format")
        g.add_argument("mode", choices=["e", "d"])
        g.add_argument("infile")
        g.add_argument("outfile")
        g.add_argument("--no-verify", action="store_true",
                       help="skip the host round-trip check of the encode")
        g.add_argument("--device", default=None,
                       help="torch device: e encodes on it (default cuda); d inverts on it "
                       "(default: the host walk)")
    g6 = sub.add_parser("a6", help="a6-compatible format")
    g6.add_argument("infile")
    g6.add_argument("outfile")
    g6.add_argument("-c", "--coder", default="byte", choices=["byte", "fix", "var"])
    g6.add_argument("-r", "--radix", type=int, default=16,
                    help="accepted for reference compatibility; output is radix-independent")
    g6.add_argument("-o", "--order", default="none",
                    choices=["none", "freq", "greedy", "topo", "bubble"],
                    help="alphabet reorder heuristic; other than none it writes an "
                    "extension blob carrying the 256-byte table")
    g6.add_argument("-u", "--unpack", action="store_true")
    g6.add_argument("--device", default="cuda", help="torch device to run on")
    for mode in ("e", "d"):
        gb = sub.add_parser(mode, help="block-streamed container")
        gb.add_argument("infile")
        gb.add_argument("outfile")
        gb.add_argument("-g", "--generation", default="a4", choices=["a4", "a7"])
        gb.add_argument("-b", "--block-size", type=lambda s: int(s, 0), default=None)
        if mode == "e":
            gb.add_argument("--no-verify", action="store_true",
                            help="skip the per-block check (the device LF certificate for "
                            "micro and v3, the host round trip for stream)")
            gb.add_argument("--impl", default="micro", choices=["micro", "v3", "stream", "it2"],
                            help="device program: cascade-free batched fast path with a "
                            "per-row fallback (micro), batched with the cascade inside (v3), "
                            "block by block (stream), or block by block through the IT-2 "
                            "reduced-volume path with its v3 fallback (it2); all write the "
                            "same bytes")
            gb.add_argument("--dp", type=int, default=1,
                            help="shard the block batch over N devices (data parallel)")
            gb.add_argument("--sp", type=int, default=1,
                            help="encode as ONE megablock text-sharded over N devices "
                            "(ATM1 container)")
            gb.add_argument("--resume", action="store_true",
                            help="continue an interrupted encode: keep complete blocks "
                            "already in OUTFILE, truncate any partial frame, encode the rest")
            gb.add_argument("--pack", action="store_true",
                            help="entropy-pack each block (ATA2 container)")
            gb.add_argument("--device", default="cuda", help="torch device to encode on")
    return p


def _config_from_args(args) -> ArchonConfig:
    cfg = ArchonConfig()
    cfg.generation = getattr(args, "generation", None) or (
        args.cmd if args.cmd in ("a4", "a6", "a7") else "a4"
    )
    cfg.verify = not getattr(args, "no_verify", False)
    cfg.block_size = getattr(args, "block_size", None) or cfg.block_size
    cfg.pack = getattr(args, "pack", False)
    cfg.impl = getattr(args, "impl", cfg.impl)
    cfg.resume = getattr(args, "resume", False)
    cfg.coder = getattr(args, "coder", cfg.coder)
    cfg.order = getattr(args, "order", cfg.order)
    cfg.radix = getattr(args, "radix", cfg.radix)
    cfg.dp = getattr(args, "dp", cfg.dp)
    cfg.sp = getattr(args, "sp", cfg.sp)
    cfg.profile_dir = getattr(args, "profile_dir", None) or os.environ.get("ARCHON_PROFILE_DIR")
    # a4|a7 d: the host walk unless a device was asked for
    cfg.use_native = getattr(args, "device", None) is None
    return cfg


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = _config_from_args(args)
    _rw = functools.partial(_rw_timed, profile_dir=cfg.profile_dir)
    if args.cmd in ("a4", "a7"):
        from . import formats

        if args.mode == "e":
            _rw(args, lambda d: formats.encode(d, cfg.generation, cfg.verify,
                                               args.device or "cuda"))
        else:
            _rw(args, lambda d: formats.decode(d, cfg.generation,
                                               None if cfg.use_native else args.device))
    elif args.cmd == "a6":
        from .core import a6

        if args.unpack:
            _rw(args, lambda d: a6.a6_decode(d, cfg.coder, cfg.order, args.device))
        else:
            _rw(args, lambda d: a6.a6_encode(d, cfg.coder, cfg.order, args.device))
    elif args.cmd == "e":
        from .io import blocks

        blocks._check_args(cfg.generation, cfg.block_size)
        if cfg.sp > 1:
            _rw(args, lambda d: _encode_sharded(d, cfg.sp, cfg.generation, args.device))
        elif cfg.resume:
            # complete frames already in OUTFILE are kept, a trailing partial
            # frame is truncated, and only the missing blocks are recomputed
            with open(args.infile, "rb") as f:
                d = f.read()
            t0 = time.perf_counter()
            n_done = blocks.encode_to_path(
                d, args.outfile, cfg.generation, cfg.block_size, resume=True,
                verify=cfg.verify, impl=cfg.impl, pack=cfg.pack, device=args.device,
            )
            dt = time.perf_counter() - t0
            print(f"{len(d)} -> {os.path.getsize(args.outfile)} bytes "
                  f"({n_done} block(s) recomputed, {dt:.3f} s)")
        else:
            _rw(args, lambda d: blocks.encode_file(
                d, cfg.generation, cfg.block_size, verify=cfg.verify, impl=cfg.impl,
                dp=cfg.dp, pack=cfg.pack, device=args.device,
            ))
    else:
        from .io import blocks
        from .parallel import megapipe

        def _decode_any(d):
            if d[:4] == megapipe.MAGIC:  # sharded megablock container
                return megapipe.decode_megablock(d)
            return blocks.decode_file(d)

        _rw(args, _decode_any)
    return 0


if __name__ == "__main__":
    sys.exit(main())
