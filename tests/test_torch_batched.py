"""Port's batched forward BWT (archon_tpu_torch.core.batched, core.bwt) vs
archon_tpu.core.batched / core.bwt.

Same seeded numpy inputs through both packages, on the CPU (the port's sorts
take their plain twins, the JAX functions run as tier-1 runs them); every
comparison is exact (integer outputs, tolerance 0).  Stage by stage the
sorted-order state (si, rs, ac, na, prev_s), the extraction, both micro
rounds and a narrowed round must match bit for bit; then the four entry
points for both sentinels, on the inputs of tests/test_batched.py.  On rows
the micro program reports unresolved, L2 and base2 are garbage by contract
and are not compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archon_tpu.core import batched as jb
from archon_tpu.core import bwt as jbwt
from archon_tpu.golden import sa as golden
from archon_tpu.utils.corpus import gauntlet_cases, text_like
from archon_tpu_torch.core import batched as tb
from archon_tpu_torch.core import bwt as tbwt

SENTINELS = ["small", "large"]


def _t(a):
    return torch.tensor(np.asarray(a))  # a copy: the port scatters in place


def _same(got, want, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want), what


def _block_matrix(n: int, seed: int = 5):
    """The regimes of tests/test_batched.py in one batch: random, text-like,
    a constant run, periodic, a sparse alphabet, three gauntlet cases."""
    rng = np.random.default_rng(seed)
    rows = [
        rng.integers(0, 256, n, dtype=np.uint8),
        np.frombuffer(text_like(n, seed + 1), np.uint8),
        np.zeros(n, np.uint8),
        np.frombuffer((b"ab" * n)[:n], np.uint8),
        rng.integers(0, 3, n, dtype=np.uint8),
    ]
    for blob in list(gauntlet_cases(n).values())[:3]:
        rows.append(np.frombuffer((blob * (n // len(blob) + 1))[:n], np.uint8))
    return np.stack(rows)


def _planted_repeat_row(n, rep_len, alpha, seed):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, alpha, n, dtype=np.uint8)
    blk = rng.integers(0, alpha, rep_len, dtype=np.uint8)
    row[500 : 500 + rep_len] = blk
    row[n // 2 : n // 2 + rep_len] = blk
    return row


def _mixed_tail_rows(n=32768):
    """Rows that leave the full rounds differently: resolved, a micro
    residue, a micro residue after one round, ties beyond the micro tail."""
    rng = np.random.default_rng(21)
    return np.stack([
        rng.integers(0, 256, n, dtype=np.uint8),
        _planted_repeat_row(n, 100, 256, 22),
        _planted_repeat_row(n, 500, 2, 23),
        _planted_repeat_row(n, 1000, 2, 24),
    ])


def _unresolved_rows(n=32768):
    """Row 1 leaves the bootstrap with about 2000 actives (under n/16, so no
    full round runs) tied 1000 bytes deep: beyond the micro tail's context
    of 192, so the micro program must flag it; rows 0 and 2 resolve."""
    rng = np.random.default_rng(7)
    return np.stack([
        rng.integers(0, 256, n, dtype=np.uint8),
        _planted_repeat_row(n, 1000, 256, 9),
        _planted_repeat_row(n, 60, 256, 10),
    ])


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_stages_match_jax(sentinel):
    rows = _mixed_tail_rows(16384)[1:]
    B, n = rows.shape
    prev = np.roll(rows, 1, axis=1)
    jrows, jprev = jnp.asarray(rows), jnp.asarray(prev)

    _same(tb._trigram_keys2(_t(rows), sentinel), jb._trigram_keys2(jrows, sentinel), "p27")

    got = tb._bootstrap_sorted2(_t(rows), _t(prev), sentinel)
    want = jb._bootstrap_sorted2(jrows, jprev, sentinel)
    for g, w, what in zip(got, want, ("si", "rs", "ac", "na", "prev_s")):
        _same(g, w, f"bootstrap {what}")
    si, rs, ac, na, _ = want

    got = tb._round_full_sorted2(_t(si), _t(rs), _t(prev), 12, sentinel)
    want = jb._round_full_sorted2(si, rs, jprev, jnp.int32(12), sentinel)
    for g, w, what in zip(got, want, ("si", "rs", "ac", "na", "prev_s", "rank")):
        _same(g, w, f"full round {what}")
    si, rs, ac, na, _, G = want
    assert int(np.asarray(na).min()) > 0, "every stage row must keep actives after a round"

    _same(tb._invert_rows(_t(si), _t(rs)), jb._invert_rows(si, rs), "invert rows")
    for cap in (4096, 1024):
        got = tb._compact_from_round2(_t(si), _t(rs), _t(ac), cap)
        for g, w in zip(got, jb._compact_from_round2(si, rs, ac, cap)):
            _same(g, w, f"compact cap={cap}")
    cap = 128  # n > cap * 32: the tiled extraction
    clip = jnp.minimum(na, cap)  # the extraction's contract: na <= cap per row
    got = tb._extract_actives_sorted2(_t(si), _t(rs), _t(ac), _t(clip), cap)
    want = jb._extract_actives_sorted2(si, rs, ac, clip, cap)
    for g, w in zip(got, want):
        _same(g, w, "extract actives")

    apos, ar0 = jb._compact_from_round2(si, rs, ac, 4096)
    g = 12
    got = tb._micro_round2(_t(G), g, _t(apos), _t(ar0), 4, 16, sentinel)
    want = jb._micro_round2(G, jnp.int32(g), apos, ar0, 4, 16, sentinel)
    for a, b, what in zip(got, want, ("pos", "r", "na")):
        _same(a, b, f"micro round 1 {what}")
    pos1, r1, _ = want
    got = tb._micro_round2(_t(G), g, _t(pos1), _t(r1), 16, 64, sentinel)
    want = jb._micro_round2(G, jnp.int32(g), pos1, r1, 16, 64, sentinel)
    for a, b, what in zip(got, want, ("pos", "r", "na")):
        _same(a, b, f"micro round 2 {what}")

    rank = jb._invert_rows(si, rs)
    got = tb._round_active2c(_t(rank), _t(apos), _t(ar0), 48, sentinel)
    want = jb._round_active2c(rank, apos, ar0, jnp.int32(48), sentinel)
    for a, b, what in zip(got, want, ("rank", "apos", "ar0", "na")):
        _same(a, b, f"narrowed round {what}")


ENTRY = {
    "micro": (tb.bwt_batched_micro, jb.bwt_batched_micro, ("L", "base", "resolved")),
    "micro_certified": (tb.bwt_batched_micro_certified, jb.bwt_batched_micro_certified,
                        ("L", "base", "ok", "resolved")),
    "v3": (tb.bwt_batched_v3, jb.bwt_batched_v3, ("L", "base")),
    "v3_certified": (tb.bwt_batched_v3_certified, jb.bwt_batched_v3_certified,
                     ("L", "base", "ok")),
}


def _hold_entry(name, rows, sentinel):
    """The port's entry point against its JAX twin on ``rows``; returns the
    port's outputs by name (numpy)."""
    tfn, jfn, names = ENTRY[name]
    got = dict(zip(names, (x.numpy() for x in tfn(_t(rows), sentinel))))
    want = dict(zip(names, (np.asarray(x) for x in jfn(jnp.asarray(rows), sentinel))))
    keep = want.get("resolved", np.ones(len(rows), bool))
    for what in names:
        if what == "resolved":
            _same(got[what], want[what], f"{name} {what}")
        else:
            _same(got[what][keep], want[what][keep], f"{name} {what} on resolved rows")
    return got


@pytest.mark.parametrize("sentinel", SENTINELS)
@pytest.mark.parametrize("name", sorted(ENTRY))
def test_entry_points_match_jax_and_golden(name, sentinel):
    rows = _block_matrix(700, seed=13)
    got = _hold_entry(name, rows, sentinel)
    assert got.get("resolved", np.ones(1, bool)).all() and got.get("ok", np.ones(1, bool)).all()
    for b in range(rows.shape[0]):
        want_L, want_base = golden.bwt_forward(rows[b], sentinel)
        assert got["L"][b].tolist() == want_L.tolist() and int(got["base"][b]) == int(want_base), b


@pytest.mark.parametrize("name,sentinel", [("v3", "small"), ("v3_certified", "large"),
                                            ("micro", "large"), ("micro_certified", "small")])
def test_mixed_tail_batch_matches_jax(name, sentinel):
    """One batch whose rows leave through different branches (resolved, micro
    residue, cascade); the micro program flags the deep row and v3 takes its
    cascade for it."""
    rows = _mixed_tail_rows()
    got = _hold_entry(name, rows, sentinel)
    resolved = got.get("resolved", np.ones(len(rows), bool))
    assert resolved[:3].all() and got.get("ok", resolved)[resolved].all()
    assert bool(resolved[3]) == name.startswith("v3")
    for b in np.nonzero(resolved)[0]:
        want_L, want_base = golden.bwt_forward(rows[b], sentinel)
        assert got["L"][b].tolist() == want_L.tolist() and int(got["base"][b]) == int(want_base), b


@pytest.mark.parametrize("name,sentinel", [("micro", "small"), ("micro_certified", "large"),
                                            ("v3", "large"), ("v3_certified", "small")])
def test_unresolved_batch_matches_jax(name, sentinel):
    rows = _unresolved_rows()
    got = _hold_entry(name, rows, sentinel)
    if "resolved" in got:
        assert got["resolved"].tolist() == [True, False, True]
        if "ok" in got:
            assert got["ok"][[0, 2]].all()
    else:  # v3 takes its cascade for the whole batch
        assert got.get("ok", np.ones(1, bool)).all()
        want_L, want_base = golden.bwt_forward(rows[1], sentinel)
        assert got["L"][1].tolist() == want_L.tolist() and int(got["base"][1]) == int(want_base)


@pytest.mark.parametrize("batch", ["micro", "cascade"])
def test_v3_body_carries_a_caller_payload(batch):
    """``_bwt_batched_v3_impl`` with a payload other than the roll, on more
    than one row (the a6 entry ``fast2.bwt_v3_payload`` runs it on one):
    each row equals ``bwt_v3_payload`` of that row, the port's and JAX's,
    whether the batch leaves through the micro tail or the cascade."""
    from archon_tpu.core import fast2 as jf
    from archon_tpu_torch.core import fast2 as tf

    rng = np.random.default_rng(31)
    if batch == "micro":
        rows = rng.integers(0, 3, (2, 4000), dtype=np.uint8)
    else:
        rows = _unresolved_rows()
    pay = rng.integers(0, 256, rows.shape, dtype=np.uint8)
    L2, base2, _ = tb._bwt_batched_v3_impl(_t(rows), _t(pay), "large", want_rank=False)
    for b in range(rows.shape[0]):
        L, base = tf.bwt_v3_payload(_t(rows[b]), _t(pay[b]), "large")
        jL, jbase = jf.bwt_v3_payload(jnp.asarray(rows[b]), jnp.asarray(pay[b]), "large")
        _same(L2[b], jL, f"row {b} against JAX")
        _same(L, jL, f"row {b} alone against JAX")
        assert int(base2[b]) == base == int(jbase), b


def test_trivial_widths_match_jax():
    for n in (0, 1):
        rows = np.full((3, n), 7, np.uint8)
        for name in sorted(ENTRY):
            _hold_entry(name, rows, "small")
    assert tb.verify_bwt_batched(_t(np.zeros((2, 0), np.uint8)), _t(np.zeros((2, 0), np.int32)),
                                 _t(np.zeros((2, 0), np.uint8)), _t(np.zeros(2, np.int32))).all()


def _certificate_inputs(sentinel, n=512):
    mat = _block_matrix(n, seed=9)[:6]
    sas = [golden.suffix_array(row, sentinel) for row in mat]
    rank2 = np.stack([np.argsort(sa).astype(np.int32) for sa in sas])
    fwd = [golden.bwt_forward(row, sentinel) for row in mat]
    return mat, rank2, np.stack([f[0] for f in fwd]), np.asarray([f[1] for f in fwd], np.int32)


def _corrupt(kind, rank2, L2, base2):
    """The corruptions tests/test_verified.py plants, and the row each hits."""
    rank2, L2, base2 = rank2.copy(), L2.copy(), base2.copy()
    n = L2.shape[1]
    if kind == "wrong_L_byte":
        L2[0, 17] ^= 0xFF
        return rank2, L2, base2, 0
    if kind == "wrong_base":
        base2[1] = (base2[1] + 1) % n
        return rank2, L2, base2, 1
    if kind == "rank_not_a_permutation":
        rank2[2, 5] = rank2[2, 6]
        return rank2, L2, base2, 2
    if kind == "rank_wrong_order":
        rank2[0, [3, 4]] = rank2[0, [4, 3]]
        return rank2, L2, base2, 0
    return rank2, L2, base2, None


@pytest.mark.parametrize("sentinel", SENTINELS)
@pytest.mark.parametrize("kind", ["clean", "wrong_L_byte", "wrong_base",
                                  "rank_not_a_permutation", "rank_wrong_order"])
def test_certificate_matches_jax_and_rejects_corruption(kind, sentinel):
    mat, rank2, L2, base2 = _certificate_inputs(sentinel)
    rank2, L2, base2, hit = _corrupt(kind, rank2, L2, base2)
    got = tb.verify_bwt_batched(_t(mat), _t(rank2), _t(L2), _t(base2), sentinel).numpy()
    _same(got, jb.verify_bwt_batched(mat, rank2, L2, base2, sentinel), kind)
    want = np.ones(len(mat), bool)
    if hit is not None:
        want[hit] = False
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("sentinel", SENTINELS)
@pytest.mark.parametrize("kind", ["clean", "swapped", "duplicate", "wrong_convention"])
def test_verify_sa_matches_jax(kind, sentinel):
    data = np.frombuffer((b"abracadabra" * 40)[:433], np.uint8)
    other = "large" if sentinel == "small" else "small"
    sa = golden.suffix_array(data, other if kind == "wrong_convention" else sentinel)
    sa = np.asarray(sa, np.int32).copy()
    if kind == "swapped":
        sa[[10, 11]] = sa[[11, 10]]
    elif kind == "duplicate":
        sa[20] = sa[21]
    got = bool(tbwt.verify_sa(_t(data), _t(sa), sentinel))
    assert got == bool(jbwt.verify_sa(jnp.asarray(data), jnp.asarray(sa), sentinel))
    assert got == (kind == "clean")
    assert bool(tbwt.verify_sa(_t(data[:0]), _t(sa[:0]), sentinel))


def test_counters_count_rounds_and_reads():
    """``stats`` counts a batch's sorting rounds and the host reads of the
    active count: a text batch that resolves in the bootstrap and one full
    round reads twice."""
    rows = np.stack([np.frombuffer(text_like(2048, s), np.uint8) for s in range(3)])
    tb.stats.reset()
    _, _, resolved = tb.bwt_batched_micro(_t(rows), "small")
    assert resolved.all()
    assert tb.stats.rounds >= 1 and tb.stats.host_syncs >= 1
    assert tb.stats.host_syncs <= tb.stats.rounds + 1


@pytest.mark.parametrize("sentinel", SENTINELS)
def test_parallel_blocks_match_jax(sentinel):
    """``parallel/blocks`` without a mesh: the four forward entry points and
    the batched inverse against the JAX package's."""
    from archon_tpu.parallel import blocks as jp
    from archon_tpu_torch.parallel import blocks as tp

    rows = _block_matrix(333, seed=17)[:5]
    pairs = [(tp.bwt_blocks, jp.bwt_blocks), (tp.bwt_blocks_certified, jp.bwt_blocks_certified),
             (tp.bwt_blocks_micro, jp.bwt_blocks_micro),
             (tp.bwt_blocks_micro_certified, jp.bwt_blocks_micro_certified)]
    for tfn, jfn in pairs:
        got, want = tfn(_t(rows), sentinel), jfn(jnp.asarray(rows), sentinel)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, tfn.__name__)
    L, base = got[0], got[1]
    back = tp.unbwt_blocks(L, base, sentinel)
    _same(back, jp.unbwt_blocks(jnp.asarray(L.numpy()), jnp.asarray(base.numpy()), sentinel),
          "unbwt_blocks")
    _same(back, rows[:, ::-1], "the inverse emits each row reversed")
