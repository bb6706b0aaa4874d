"""Command-line interface of the PyTorch/CUDA port (argument names as in
``archon_tpu/cli.py``):

  python -m archon_tpu_torch a4|a7 e|d <in> <out> [--no-verify] [--device D]
                                        # a4/a7-compatible single block
  python -m archon_tpu_torch e|d <in> <out> [-g a4|a7] [-b BLOCK] [--pack]
                                [--no-verify] [--device D]
                                        # block-streamed ATA1/ATA2 container
"""

from __future__ import annotations

import argparse
import sys
import time

from .host import ArchonConfig


def _rw_timed(args, fn):
    """Read, transform, write; report sizes and the transform's wall time."""
    with open(args.infile, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    out = fn(data)
    dt = time.perf_counter() - t0
    with open(args.outfile, "wb") as f:
        f.write(out)
    print(f"{len(data)} -> {len(out)} bytes")
    print(f"Transform time: {dt:.3f} sec ({len(data) / 1e6 / max(dt, 1e-9):.1f} MB/s)")


def _parser():
    p = argparse.ArgumentParser(prog="python -m archon_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    for gen in ("a4", "a7"):
        g = sub.add_parser(gen, help=f"{gen}-compatible single-block format")
        g.add_argument("mode", choices=["e", "d"])
        g.add_argument("infile")
        g.add_argument("outfile")
        g.add_argument("--no-verify", action="store_true",
                       help="skip the host round-trip check of the encode")
        g.add_argument("--device", default="cuda", help="torch device to encode on")
    for mode in ("e", "d"):
        gb = sub.add_parser(mode, help="block-streamed container")
        gb.add_argument("infile")
        gb.add_argument("outfile")
        gb.add_argument("-g", "--generation", default="a4", choices=["a4", "a7"])
        gb.add_argument("-b", "--block-size", type=lambda s: int(s, 0), default=None)
        if mode == "e":
            gb.add_argument("--no-verify", action="store_true",
                            help="skip the per-block host round-trip check")
            gb.add_argument("--pack", action="store_true",
                            help="entropy-pack each block (ATA2 container)")
            gb.add_argument("--device", default="cuda", help="torch device to encode on")
    return p


def _config_from_args(args) -> ArchonConfig:
    cfg = ArchonConfig()
    cfg.generation = getattr(args, "generation", None) or (
        args.cmd if args.cmd in ("a4", "a7") else "a4"
    )
    cfg.verify = not getattr(args, "no_verify", False)
    cfg.block_size = getattr(args, "block_size", None) or cfg.block_size
    cfg.pack = getattr(args, "pack", False)
    return cfg


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = _config_from_args(args)
    if args.cmd in ("a4", "a7"):
        from . import formats

        if args.mode == "e":
            _rw_timed(args, lambda d: formats.encode(d, cfg.generation, cfg.verify, args.device))
        else:
            _rw_timed(args, lambda d: formats.decode(d, cfg.generation))
    elif args.cmd == "e":
        from .io import blocks

        _rw_timed(args, lambda d: blocks.encode_file(
            d, cfg.generation, cfg.block_size, verify=cfg.verify, pack=cfg.pack,
            device=args.device,
        ))
    else:
        from .io import blocks

        _rw_timed(args, blocks.decode_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
