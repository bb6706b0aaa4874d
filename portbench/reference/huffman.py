"""Huffman code table of the a6 'var' coder, as the ATM1 container uses it.

Frozen copy of ``huff_compute`` and ``build_encoder_var`` from
``archon_tpu/entropy/huffman.py``, the builder of the golden a6 coder
(``archon_tpu/golden/a6.py``): a replica of a6/src/huff.c:74-129 and
coder.c:84-101, whose tie-breaking the format depends on.  The decoder
rebuilds the table from the stored histogram, so the reference must too.
``portbench/tests`` hold it to tables taken from that builder and to
Kraft's equality and the optimal cost on every histogram they try.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SymbolCode:
    code: int
    length: int


def huff_compute(weights: list[int]) -> list[SymbolCode]:
    """Build Huffman codes for ``weights`` (one per registered symbol, in
    registration order), replicating a6/src/huff.c:74-129 exactly.

    Returns a SymbolCode per input weight.  Code bits are MSB-first in
    ``code`` (value accumulated root-down: child.value = own_bit +
    (parent.value << 1), huff.c:121)."""
    total = len(weights)
    if total == 0:
        return []
    # node arrays: parent, weight, value(bit then code), length
    parent = [-1] * total
    weight = list(weights)
    value = [0] * total
    length = [0] * total
    next_id = total

    def huff_add(w: int) -> int:
        nonlocal next_id
        parent.append(-1)
        weight.append(w)
        value.append(0)
        length.append(0)
        i = next_id
        next_id += 1
        return i

    table = list(range(total))
    num_left = total
    while num_left > 1:
        # choose the two minimum-weight entries (huff.c:82-100): scan with
        # strict comparisons so earlier table slots win ties
        min0, min1 = 0, 1
        w0 = weight[table[0]]
        w1 = weight[table[1]]
        if w0 > w1:
            w0, w1 = w1, w0
            min0, min1 = 1, 0
        for i in range(2, num_left):
            w = weight[table[i]]
            if w >= w1:
                continue
            if w < w0:
                min1, w1 = min0, w0
                min0, w0 = i, w
            else:
                min1, w1 = i, w
        # compose a new node (huff.c:101-112)
        i = huff_add(w0 + w1)
        parent[table[min0]] = i
        parent[table[min1]] = i
        value[table[min0]] = 0
        value[table[min1]] = 1
        num_left -= 1
        if min0 != num_left:
            table[min0] = i if min1 == num_left else table[num_left]
        table[min1] = i

    # fill in the codes root-down (huff.c:114-126)
    length[table[0]] = 0
    if next_id == 1:
        # single symbol: zero-length code, as the reference produces
        return [SymbolCode(0, 0)]
    for i in range(next_id - 2, -1, -1):
        par = parent[i]
        value[i] += value[par] << 1
        length[i] = 1 + length[par]
    return [SymbolCode(value[i], length[i]) for i in range(total)]


def build_encoder_var(freq) -> list[SymbolCode]:
    """a6 'var' encoder table (coder_build_encoder, a6/src/coder.c:84-101):
    Huffman over nonzero-frequency bytes registered in ascending byte order.
    Returns 256 SymbolCodes (zero-length for absent bytes)."""
    present = [i for i in range(256) if freq[i]]
    codes = huff_compute([int(freq[i]) for i in present])
    out = [SymbolCode(0, 0) for _ in range(256)]
    for sym, sc in zip(present, codes):
        out[sym] = sc
    return out
