"""The Fibonacci word, a Gauntlet construction (maximal repetition density).

Frozen copy of ``fibonacci_string`` in ``archon_tpu_torch/utils/corpus.py``.
"""

from __future__ import annotations


def fibonacci_string(n: int, a: bytes = b"a", b: bytes = b"b") -> bytes:
    s0, s1 = b, a
    while len(s1) < n:
        s0, s1 = s1, s1 + s0
    return s1[:n]
