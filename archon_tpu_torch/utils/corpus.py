"""Test/bench corpus synthesis.

The Calgary/Gauntlet corpora named in the reference README (reference
README.md:5-7) are not shipped, so they are reproduced in spirit:

- ``gauntlet_cases`` generates the pathological long-repetition family the
  Gauntlet corpus is built around (runs, small periods, nested repeats,
  Fibonacci strings, de Bruijn-ish text) — the inputs that defeat
  comparison-based suffix sorts and motivated a4's anchor "defense"
  (a4/src/direct.c:82-161).
- ``text_like`` produces Markov-ish English-like text for throughput
  benchmarks standing in for enwik8/Calgary when they are absent.
- ``load_or_synthesize`` prefers a real corpus file if one exists on disk.

The port's own copy of ``archon_tpu/utils/corpus.py``: the generators are
byte-identical, so both packages' tests and smoke runs see the same inputs.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def fibonacci_string(n: int, a: bytes = b"a", b: bytes = b"b") -> bytes:
    """Fibonacci word: maximal repetition density, classic sorter-killer."""
    s0, s1 = b, a
    while len(s1) < n:
        s0, s1 = s1, s1 + s0
    return s1[:n]


def gauntlet_cases(size: int = 1 << 12) -> dict[str, bytes]:
    rng = np.random.default_rng(0xA4C0)
    cases = {
        "run_single": b"a" * size,
        "run_two": b"a" * (size // 2) + b"b" * (size // 2),
        "period2": b"ab" * (size // 2),
        "period3": b"abc" * (size // 3),
        "period_long": (b"abcdefgh" * ((size // 8) + 1))[:size],
        "fibonacci": fibonacci_string(size),
        "nested": (b"a" * 16 + b"b") * (size // 17),
        "almost_periodic": bytearray(b"ab" * (size // 2)),
        "descending": bytes(range(255, -1, -1)) * (size // 256 + 1),
        "zeros": b"\x00" * size,
        "zero_mix": bytes(rng.integers(0, 2, size, dtype=np.uint8)),
        "random": bytes(rng.integers(0, 256, size, dtype=np.uint8)),
        "random_small_alpha": bytes(rng.integers(97, 101, size, dtype=np.uint8)),
    }
    ap = cases["almost_periodic"]
    for pos in rng.integers(0, size, 8):
        ap[int(pos)] = 0x63
    cases["almost_periodic"] = bytes(ap)
    cases["descending"] = cases["descending"][:size]
    return cases


def text_like(n: int, seed: int = 7) -> bytes:
    """English-like text via an order-0 word model; stand-in for enwik8."""
    rng = np.random.default_rng(seed)
    words = (
        "the of and to in a is that it was for on are as with his they at be "
        "this have from or one had by word but not what all were we when your "
        "can said there use an each which she do how their if will up other "
        "about out many then them these so some her would make like him into "
        "time has look two more write go see number no way could people my "
        "than first water been call who oil its now find long down day did "
        "get come made may part archon suffix sort burrows wheeler transform"
    ).split()
    probs = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    probs /= probs.sum()
    chunks = []
    total = 0
    while total < n:
        picks = rng.choice(len(words), size=4096, p=probs)
        chunk = " ".join(words[i] for i in picks).encode() + b" "
        chunks.append(chunk)
        total += len(chunk)
    return b"".join(chunks)[:n]


def markup_like(n: int, seed: int = 11) -> bytes:
    """XML/wiki-ish markup text — the structural corpus class enwik8 actually
    is (a Wikipedia XML dump: nested tags, [[links]], entities, indented
    attribute lines) that plain ``text_like`` lacks (VERDICT r3 #10).

    Tie structure vs text_like: heavy *exact* medium-length repeats (every
    ``<page>``/``<revision>`` skeleton is byte-identical) drive tie depth at
    k in the tens-to-hundreds, while the word soup between tags keeps the
    deep tail bounded — matching enwik8's profile more closely than pure
    word soup.  Prefix-stable for any n (fixed seed, chunked generation)."""
    rng = np.random.default_rng(seed)
    words = (
        "the of and to in a is that it was for on are as with his they at be "
        "this have from or one had by word but not what all were we when your "
        "archon suffix sort burrows wheeler transform wikipedia article"
    ).split()
    probs = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    probs /= probs.sum()
    chunks = []
    total = 0
    page = 0
    while total < n:
        page += 1
        title = " ".join(words[i] for i in rng.choice(len(words), 2, p=probs))
        body_words = rng.choice(len(words), size=96, p=probs)
        body = []
        for t, i in enumerate(body_words):
            w = words[i]
            r = rng.random()
            if r < 0.06:
                w = "[[" + w + "]]"
            elif r < 0.09:
                w = "''" + w + "''"
            elif r < 0.11:
                w = "&amp;" + w + ";"
            body.append(w)
        chunk = (
            f"  <page>\n    <title>{title}</title>\n    <id>{page}</id>\n"
            f"    <revision>\n      <id>{page * 7}</id>\n"
            f"      <timestamp>2006-0{1 + page % 9}-1{page % 10}T0{page % 10}:"
            f"00:00Z</timestamp>\n      <contributor><username>{words[int(body_words[0])]}"
            f"</username></contributor>\n      <text xml:space=\"preserve\">"
            + " ".join(body)
            + "</text>\n    </revision>\n  </page>\n"
        ).encode()
        chunks.append(chunk)
        total += len(chunk)
    return b"".join(chunks)[:n]


_logged_choice = None


def load_or_synthesize(n: int) -> tuple[str, bytes]:
    """Prefer a real benchmark corpus; otherwise synthesize text, and say so.

    The file named by ``$ARCHON_CORPUS`` (enwik8, a Calgary tarball) is read
    when it exists; the port looks nowhere else on the disk.  Otherwise
    ``$ARCHON_CORPUS_STYLE`` (``text`` or ``markup``) picks the generator.
    Every run logs which corpus it measured."""
    global _logged_choice
    explicit = os.environ.get("ARCHON_CORPUS")
    if explicit and os.path.exists(explicit):
        if _logged_choice != explicit:
            _logged_choice = explicit
            print(f"[corpus] using real corpus {explicit}", file=sys.stderr)
        with open(explicit, "rb") as f:
            return os.path.basename(explicit), f.read(n)
    style = os.environ.get("ARCHON_CORPUS_STYLE", "text")
    if _logged_choice != "synthetic":
        _logged_choice = "synthetic"
        print(f"[corpus] no real corpus (ARCHON_CORPUS={explicit!r}): synthesizing {style} corpus",
              file=sys.stderr)
    if style == "markup":
        return "synthetic-markup", markup_like(n)
    return "synthetic-text", text_like(n)
