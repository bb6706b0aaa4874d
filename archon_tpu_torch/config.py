"""Unified configuration (SURVEY.md section 5: "single dataclass config;
keep the same switch names where meaningful").

Collects the reference's two-tier switches — compile-time feature defines
(VERIFY, USE_IT2, useItoh, ...) and runtime CLI options (a6's -c/-r/-o,
x2/x3's -b) — into one serializable dataclass consumed by the CLI and the
pipelines.

The port's own copy of ``archon_tpu/config.py``, field for field, so that a
configuration written by either package reads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict


@dataclass
class ArchonConfig:
    # format semantics
    generation: str = "a4"          # a4 | a7 | a6
    coder: str = "byte"             # a6: byte | fix | var      (-c)
    order: str = "none"             # a6 alphabet reorder        (-o; reference: parsed, never applied)
    radix: int = 16                 # a6 radix power             (-r; output-irrelevant, kept for CLI parity)

    # block streaming (x1/x2 semantics)
    block_size: int = 1 << 22       # -b; x1's historical 4 MiB default

    # verification (reference: VERIFY/VF_SORT compile-time defines)
    verify: bool = True             # always-on LF check after transform

    # checkpoint/resume (container encode: keep complete frames, truncate a
    # partial one, recompute the rest — io/blocks.encode_to_path)
    resume: bool = False            # --resume

    # compressing container (ATA2: per-block MTF+RLE0+Huffman — entropy/pack)
    pack: bool = False              # --pack

    # execution
    impl: str = "micro"             # container device program: micro (cascade-
                                    # free fast path) | v3 (in-program cascade)
    use_native: bool = True         # host decode via native C++ walk
    profile_dir: str | None = None  # profiler trace output (--profile-dir)

    # parallelism
    dp: int = 1                     # block-parallel shards (container --dp)
    sp: int = 1                     # megablock text shards (container --sp)

    def sentinel(self) -> str:
        if self.generation == "a4":
            return "small"
        return "large"  # a7 and a6 both use terminator-largest semantics

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ArchonConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})
