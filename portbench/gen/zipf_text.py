"""Zipf word-model text, made in bulk with numpy.

Frozen copy of ``synthetic_text`` in ``chip_smoke.py`` (vocabulary, weights
and layout unchanged); the benchmark keeps its own so that its traffic does
not move when that script does.
"""

from __future__ import annotations

import numpy as np

_WORDS = (
    "a an the and or but if of to in on at by for with from as is are was be "
    "been it its this that these those we you they he she not no all any some "
    "one two three time year day way part place work word number people water "
    "block sort suffix rank context stream device kernel merge tile round key "
    "compress transform burrows wheeler archon text file byte order index"
).split()


def zipf_text(n: int, seed: int) -> bytes:
    """Word-model text: Zipf-weighted words from a fixed vocabulary, with
    sentence breaks and line ends."""
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
