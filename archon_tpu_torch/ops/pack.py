"""The ATA2 entropy pack of a (B, n) batch of BWT rows on the device where
they lie: MTF, zero-run coding (RUNA/RUNB), the 257-symbol histogram and
LSB-first bit packing, byte for byte the host pack's
(``entropy.pack.pack_block``: ``native.mtf_rle0``, ``native.bitpack16``).

Two calls, because the Huffman codes are built on the host from each row's
histogram in between:

- ``mtf_rle(L)`` enqueues the passes that need nothing from the host and
  returns a ``RowState``: each row's histogram and symbol count m in
  ``head`` (the one small tensor the host reads), and what ``pack_words``
  needs on the device;
- ``pack_words(state, codes, lens, row_word, total)`` packs the rows given
  a first word in ``row_word`` into one zeroed buffer of ``total`` u32 words,
  each row's ``ceil(nbits / 32)`` words from there.

The kernels are ``csrc/pack.cu`` (built with the others by ``ops._build``):
``mtf_rle`` is four launches (last occurrences a chunk, their scan over the
chunks, MTF and the runs inside each chunk, the runs across chunks with the
histograms), ``pack_words`` two (each chunk's first bit, the words).  They
replace no TPU kernel: the JAX package packs on the host only.  Rows are cut
into chunks of ``chunk`` bytes (``PACK_CHUNK`` on the card, ``TWIN_CHUNK`` on
the CPU by default), each MTF'd from the list that the symbols' last
occurrences before it give; the result does not depend on ``chunk``.

Each call has a plain twin (``mtf_rle_ref``, ``pack_words_ref``) taken for
tensors on the CPU; on a CUDA tensor the wrapper launches its kernels or
raises.  ``mtf_rle.launches`` and ``pack_words.launches`` count the calls
that launched kernels.  ``symbols(state)`` lays each row's symbol stream out
from a state (for tests and checks; the pack itself never gathers it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NSYM = 257  # entropy.pack.NSYM: RUNA, RUNB, MTF ranks 1..255 as 2..256
HEAD = NSYM + 1  # a row's histogram, then m
META = 6  # per chunk: interior count, lead, trail, seen, zhead, ztail (kMeta)
PACK_CHUNK = 4096  # bytes a chunk on the card: 8192 chunks of a (8, 4 MiB) unit
TWIN_CHUNK = 64  # the twin's default: on the CPU a step of the MTF loop costs its overhead
MAX_CHUNK = 8192  # kMaxChunk in csrc/pack.cu: a chunk's words fit in shared memory
_U32 = 0xFFFFFFFF


class RowState(NamedTuple):
    """What ``mtf_rle`` leaves for ``pack_words``, all on L's device.

    ``syms`` (B, n) int16: chunk k's span ``[k * chunk, (k + 1) * chunk)``
    holds, from its start, the ``meta[..., 0]`` symbols coded inside the
    chunk (the rest is scratch).  ``meta`` (B, nch, META) int32 per chunk:
    those symbols' count; the zeros before its first nonzero rank and after
    its last (its length for a chunk of zeros only); whether it has a
    nonzero rank; ``zhead``, the zero run coded at the chunk's start (0: none);
    ``ztail``, the run coded at the row's end (last chunk only).  ``chist``
    (B, nch, NSYM) int32: each chunk's share of the histogram.  ``head`` (B,
    HEAD) int32: each row's histogram, then m."""

    chunk: int
    syms: torch.Tensor
    meta: torch.Tensor
    chist: torch.Tensor
    head: torch.Tensor


def _rows(L) -> torch.Tensor:
    if not isinstance(L, torch.Tensor) or L.dim() != 2 or L.dtype != torch.uint8:
        raise ValueError("L must be a (B, n) uint8 tensor")
    if not L.is_contiguous():
        raise ValueError("L must be contiguous")
    if L.shape[0] < 1 or not 1 <= L.shape[1] < (1 << 30):
        raise ValueError("L needs at least one row of 1 to 2^30 - 1 bytes")
    return L


def _check_chunk(chunk: int) -> int:
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}]")
    return chunk


def _launch_check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, not {t.device}")


def _run_digits(z: torch.Tensor) -> torch.Tensor:
    """Digits of each zero run z >= 0 in bijective base 2: floor(log2(z + 1))."""
    x = z.to(torch.int64) + 1
    d = torch.floor(torch.log2(x.double())).to(torch.int64)
    d = d - ((torch.ones_like(d) << d) > x).long()  # exact at the powers of two
    return d + ((torch.ones_like(d) << (d + 1)) <= x).long()


def _digit_steps(z: torch.Tensor):
    """Yield (active, digit) per digit of each run in ``z``, least
    significant first: digit 0 is RUNA, 1 is RUNB."""
    z = z.to(torch.int64).clone()
    while bool((z > 0).any()):
        act = z > 0
        d = torch.where(act, (z - 1) & 1, 0)
        yield act, d
        z = torch.where(act, (z - d - 1) >> 1, 0)


# ---------------------------------------------------------------- plain twins


def _mtf_ranks(L: torch.Tensor, chunk: int) -> torch.Tensor:
    """MTF ranks (B, nch, chunk) int64, each chunk from the list its
    symbols' last occurrences before it give (padding past n: rank 0)."""
    B, n = L.shape
    nch = -(-n // chunk)
    Lp = torch.zeros(B, nch * chunk, dtype=torch.int64)
    Lp[:, :n] = L
    Lp = Lp.view(B, nch, chunk)
    pos = torch.arange(nch * chunk, dtype=torch.int64).view(1, nch, chunk).expand(B, nch, chunk)
    valid = pos < n
    occ = torch.full((B, nch, 256), -1, dtype=torch.int64)
    occ.scatter_reduce_(2, Lp, torch.where(valid, pos, -1), "amax")
    last = occ.cummax(dim=1).values
    start = torch.cat([torch.full((B, 1, 256), -1, dtype=torch.int64), last[:, :-1]], 1)
    T = torch.where(start >= 0, start, -1 - torch.arange(256)).view(B * nch, 256)
    Lf, pf, vf = Lp.view(B * nch, chunk), pos.reshape(B * nch, chunk), valid.view(B * nch, chunk)
    ranks = torch.zeros(B * nch, chunk, dtype=torch.int64)
    for j in range(min(chunk, n)):
        s = Lf[:, j : j + 1]
        ts = T.gather(1, s)
        ranks[:, j] = torch.where(vf[:, j], (T > ts).sum(1), 0)
        T.scatter_(1, s, torch.where(vf[:, j : j + 1], pf[:, j : j + 1], ts))
    return ranks.view(B, nch, chunk)


def mtf_rle_ref(L: torch.Tensor, chunk: int = TWIN_CHUNK) -> RowState:
    """Plain twin of ``mtf_rle``: the same ``RowState`` (scratch past each
    chunk's symbols zero)."""
    L = _rows(L)
    chunk = _check_chunk(chunk)
    B, n = L.shape
    nch = -(-n // chunk)
    r = _mtf_ranks(L, chunk)
    j = torch.arange(chunk)
    lens = torch.clamp(n - torch.arange(nch) * chunk, max=chunk)  # (nch,)
    nz = (r != 0) & (j < lens[:, None])
    last_nz = torch.where(nz, j, -1).cummax(dim=2).values
    prev = torch.cat([torch.full((B, nch, 1), -1), last_nz[..., :-1]], 2)
    inner = nz & (prev >= 0)  # a nonzero rank whose zero run closes inside the chunk
    run = j - prev - 1
    count = nz.long() + torch.where(inner, _run_digits(run), 0)
    off = count.cumsum(2) - count
    flat = (torch.arange(B * nch).view(B, nch, 1) * chunk + off)
    syms = torch.zeros(B * nch * chunk, dtype=torch.int16)
    chist = torch.zeros(B, nch, NSYM + 1, dtype=torch.int64)
    for act, d in _digit_steps(torch.where(inner, run, 0)):
        syms[flat[act]] = d[act].to(torch.int16)
        chist[..., 0] += (act & (d == 0)).sum(2)
        chist[..., 1] += (act & (d == 1)).sum(2)
        flat = flat + act
    syms[flat[nz]] = (r[nz] + 1).to(torch.int16)
    chist.scatter_add_(2, torch.where(nz, r + 1, NSYM), torch.ones_like(r))
    chist = chist[..., :NSYM]

    seen = nz.any(2)
    first = torch.where(nz, j, chunk).min(2).values
    lastc = last_nz[..., -1]
    meta = torch.zeros(B, nch, META, dtype=torch.int64)
    meta[..., 0] = count.sum(2)
    meta[..., 1] = torch.where(seen, first, lens)
    meta[..., 2] = torch.where(seen, lens - 1 - lastc, lens)
    meta[..., 3] = seen.long()
    # the zero runs across chunks, from the row's last nonzero rank before each
    starts = torch.arange(nch) * chunk
    last_global = torch.where(seen, starts + lastc, -1)
    before = torch.cat([torch.full((B, 1), -1), last_global.cummax(dim=1).values[:, :-1]], 1)
    zhead = torch.where(seen, starts - 1 - before + meta[..., 1], 0)
    ztail = torch.zeros(B, nch, dtype=torch.int64)
    ztail[:, -1] = n - 1 - last_global.max(dim=1).values
    meta[..., 4], meta[..., 5] = zhead, ztail
    for z in (zhead, ztail):
        for act, d in _digit_steps(z):
            chist[..., 0] += act & (d == 0)
            chist[..., 1] += act & (d == 1)
    total = torch.where(seen, _run_digits(zhead) + meta[..., 0], 0) + _run_digits(ztail)
    head = torch.cat([chist.sum(1), total.sum(1, keepdim=True)], 1)
    i32 = torch.int32
    return RowState(chunk, syms.view(B, nch * chunk)[:, :n].contiguous(), meta.to(i32),
                    chist.to(i32), head.to(i32))


def symbols(state: RowState) -> list:
    """Each row's whole symbol stream, an int64 CPU tensor, laid out from
    ``state``: chunk by chunk, its ``zhead`` digits, its own symbols, then
    (last chunk) ``ztail``'s digits."""
    syms, meta, chunk = state.syms.cpu().long(), state.meta.cpu().tolist(), state.chunk
    out = []
    for b, row in enumerate(meta):
        parts = []
        for k, (cnt, _lead, _trail, seen, zhead, ztail) in enumerate(row):
            if seen:
                parts += [d for _a, d in _digit_steps(torch.tensor([zhead]))]
            parts.append(syms[b, k * chunk : k * chunk + cnt])
            parts += [d for _a, d in _digit_steps(torch.tensor([ztail]))]
        out.append(torch.cat(parts))
    return out


def pack_words_ref(state: RowState, codes: torch.Tensor, lens: torch.Tensor,
                   row_word: torch.Tensor, total: int) -> torch.Tensor:
    """Plain twin of ``pack_words``: each packed row's stream through its
    codes, LSB-first at increasing bit offsets, into ``total`` int32 words
    holding u32 values."""
    words = torch.zeros(total + 1, dtype=torch.int64)
    for b, s in enumerate(symbols(state)):
        w0 = int(row_word[b])
        if w0 < 0:
            continue
        s = s.cpu()
        c = codes[b].cpu().long()[s] & _U32
        ln = lens[b].cpu().long()[s]
        starts = ln.cumsum(0) - ln
        w = w0 + (starts >> 5)
        sh = starts & 31
        words.index_add_(0, w, (c << sh) & _U32)
        # (c >> 1) >> (31 - sh) avoids the shift by 32 when sh == 0
        words.index_add_(0, w + 1, (c >> 1) >> (31 - sh))
    words = words[:total]
    return torch.where(words > 0x7FFFFFFF, words - (1 << 32), words).to(torch.int32)


# ---------------------------------------------------------------- kernels


def mtf_rle(L: torch.Tensor, chunk: int | None = None) -> RowState:
    """MTF, zero runs and histograms of the (B, n) uint8 rows ``L``: one
    call, four kernels, nothing read back."""
    L = _rows(L)
    if L.device.type == "cpu":
        return mtf_rle_ref(L, chunk or TWIN_CHUNK)
    chunk = _check_chunk(chunk or PACK_CHUNK)
    _require_cuda(L, "mtf_rle")
    from ._build import load_library

    lib = load_library()
    B, n = L.shape
    nch = -(-n // chunk)
    dev = L.device
    occ = torch.empty((B, nch, 256), dtype=torch.int32, device=dev)
    syms = torch.empty((B, n), dtype=torch.int16, device=dev)
    meta = torch.empty((B, nch, META), dtype=torch.int32, device=dev)
    chist = torch.empty((B, nch, NSYM), dtype=torch.int32, device=dev)
    head = torch.empty((B, HEAD), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.archon_pack_mtf_rle(L.data_ptr(), B, n, chunk, occ.data_ptr(), syms.data_ptr(),
                                     meta.data_ptr(), chist.data_ptr(), head.data_ptr(), stream)
    _launch_check(rc, "mtf_rle")
    mtf_rle.launches += 1
    return RowState(chunk, syms, meta, chist, head)


def pack_words(state: RowState, codes: torch.Tensor, lens: torch.Tensor,
               row_word: torch.Tensor, total: int) -> torch.Tensor:
    """The packed words of the rows of ``state`` that ``row_word`` gives a
    first word (-1: not packed), through each row's code table: ``codes``
    (B, NSYM) int32 holding u32 codes, ``lens`` (B, NSYM) int32 lengths (at
    most 32; every symbol present in the row has one), all on the state's
    device.  Returns ``total`` int32 words holding u32 values."""
    B = state.head.shape[0]
    dev = state.syms.device
    for t, dt, shape in ((codes, torch.int32, (B, NSYM)), (lens, torch.int32, (B, NSYM)),
                         (row_word, torch.int64, (B,))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"pack_words: expected a contiguous {dt} tensor of shape {shape} on {dev}")
    if dev.type == "cpu":
        return pack_words_ref(state, codes, lens, row_word, total)
    _require_cuda(state.syms, "pack_words")
    from ._build import load_library

    lib = load_library()
    n = state.syms.shape[1]
    words = torch.zeros(max(total, 1), dtype=torch.int32, device=dev)
    cbits = torch.empty(state.meta.shape[:2], dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.archon_pack_words(state.syms.data_ptr(), state.meta.data_ptr(), state.chist.data_ptr(),
                                   codes.data_ptr(), lens.data_ptr(), row_word.data_ptr(), B, n,
                                   state.chunk, cbits.data_ptr(), words.data_ptr(), stream)
    _launch_check(rc, "pack_words")
    pack_words.launches += 1
    return words[:total]


mtf_rle.launches = 0  # calls that launched the four kernels, since import
pack_words.launches = 0  # calls that launched the two kernels, since import
