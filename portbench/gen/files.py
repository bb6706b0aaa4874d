"""The benchmark's one traffic generator: a cycle of files, made from the seed.

A traffic file (``portbench/traffic/<mix>.json``) lists the files one client
sends, one request each, in order and then again from the first::

    {"generator": "files",
     "files": [{"name": "dickens", "bytes": 10192446, "content": "zipf_text"},
               {"name": "book1x20", "bytes": 15375420, "content": "repeat", "unit": 768771},
               {"name": "fib", "bytes": 14930352, "content": "fibonacci"}]}

Contents:
- ``zipf_text``: a slice, at an offset drawn from the seed, of one pool of
  Zipf word-model text (``gen/zipf_text``) made from the seed;
- ``repeat``: a ``unit``-byte slice of that pool, repeated to ``bytes``
  (the Gauntlet's book1x20 and paper5x80 constructions);
- ``fibonacci``: the Fibonacci word of ``bytes`` (the same for every seed);
- ``planted_repeat``: random bytes from the seed with one random
  ``unit``-byte string written twice into every ``span`` bytes (default: the
  whole file), near its start and at its middle: exact repeats far longer
  than the rest of the data's ties.

Every seed gives the same sizes in the same order; only the text changes.
"""

from __future__ import annotations

import numpy as np

from .fibonacci import fibonacci_string
from .zipf_text import zipf_text

POOL_SLACK = 4 << 20  # offsets into the pool range over this much past the largest slice


def _scaled(size: int, scale: int) -> int:
    return max(1, size // scale)


def _planted(rng, size: int, unit: int, span: int) -> bytes:
    row = rng.integers(0, 256, size, dtype=np.uint8)
    rep = rng.integers(0, 256, unit, dtype=np.uint8)
    for start in range(0, size, span):
        for off in (start + min(500, span // 4), start + span // 2):
            end = min(off + unit, size)
            row[off:end] = rep[: max(0, end - off)]
    return row.tobytes()


def make(traffic: dict, seed: int, scale: int = 1) -> list[tuple[str, bytes]]:
    """[(name, data), ...] in the order the client sends them.  ``scale``
    divides every size (tests run the same mixes at a small size)."""
    files = traffic["files"]
    rng = np.random.default_rng(seed)
    slices = [_scaled(f["bytes"] if f["content"] == "zipf_text" else f.get("unit", 0), scale)
              for f in files if f["content"] in ("zipf_text", "repeat")]
    need = max(slices, default=0)
    pool = zipf_text(need + min(need // 4, POOL_SLACK), int(rng.integers(1 << 62))) if need else b""

    def cut(size: int) -> bytes:
        off = int(rng.integers(0, len(pool) - size + 1))
        return pool[off : off + size]

    out = []
    for f in files:
        size = _scaled(f["bytes"], scale)
        kind = f["content"]
        if kind == "zipf_text":
            data = cut(size)
        elif kind == "repeat":
            unit = cut(_scaled(f["unit"], scale))
            data = (unit * -(-size // len(unit)))[:size]
        elif kind == "fibonacci":
            data = fibonacci_string(size)
        elif kind == "planted_repeat":
            data = _planted(rng, size, _scaled(f["unit"], scale), _scaled(f.get("span", f["bytes"]), scale))
        else:
            raise ValueError(f"unknown content {kind!r} in file {f['name']!r}")
        out.append((f["name"], data))
    return out
