"""The check rejects what it must: the control (the reference with the exact
order broken) in place of the program, and the program with its timed path
broken underneath.  Every cell runs here small on the CPU, through the whole
of a run but the look for a card; the chip runs of the control are in
PERF.md."""

import copy

import pytest
import torch

from portbench import control, harness

SEED = 2**31 + 99
SMALL = {  # cell: (size divisor, call entries), so that a run fits a test
    "a4_micro.silesia_text": (1024, {"block_size": 8192}),
    "atm1_sp8.enwik8_text": (4000, None),
    "a4_micro.gauntlet": (256, {"block_size": 8192}),
    "a4_micro.canterbury_small": (64, {"block_size": 8192}),
}
MICRO = [c for c in SMALL if c.startswith("a4_micro.")]


def small_run(cell):
    scale, call = SMALL[cell]
    return harness.run(cell, SEED, 0.2, False, "cpu", scale=scale, call=call)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_program_is_correct(cell):
    r = small_run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks" and all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    scale, call = SMALL[cell]
    out = control.control_checks(cell, SEED, "cpu", scale, call)
    assert not out["correct"] and out["failed"] >= 1


# faults planted in the program's timed path ---------------------------------

def _altered_rows(fn):
    def wrapped(blocks, *args, **kwargs):
        L, base, ok, resolved = fn(blocks, *args, **kwargs)
        L = L.clone()
        L[0, 0] ^= 1  # one byte of the answer altered where it is produced
        return L, base, ok, resolved
    return wrapped


def _half_batch(fn):
    def wrapped(blocks, *args, **kwargs):
        half = -(-blocks.shape[0] // 2)  # the rest of the batch is left out
        L, base, ok, resolved = fn(blocks[:half], *args, **kwargs)
        idx = torch.arange(blocks.shape[0]) % half
        return L[idx], base[idx], ok[idx], resolved[idx]
    return wrapped


# canterbury_small sends one block a file, so its batches are one row and
# have no half to leave out
@pytest.mark.parametrize("cell, fault", [(c, _altered_rows) for c in MICRO] + [
    (c, _half_batch) for c in MICRO if c != "a4_micro.canterbury_small"])
def test_micro_faults_are_caught(monkeypatch, cell, fault):
    from archon_tpu_torch.parallel import blocks

    monkeypatch.setattr(blocks, "bwt_blocks_micro_certified", fault(blocks.bwt_blocks_micro_certified))
    r = small_run(cell)
    assert not r["correct"]


def test_megablock_answer_altered(monkeypatch):
    from archon_tpu_torch.parallel import megapipe

    make_emit = megapipe._make_emit

    def altered(*args):
        emit = make_emit(*args)

        def fn(rank, data):
            L, base = emit(rank, data)
            L = L.clone()
            L[0, 0] ^= 1
            return L, base
        return fn

    monkeypatch.setattr(megapipe, "_make_emit", altered)
    assert not small_run("atm1_sp8.enwik8_text")["correct"]


def test_megablock_exchange_left_out(monkeypatch):
    from archon_tpu_torch.parallel.collectives import InProcess

    monkeypatch.setattr(InProcess, "ppermute", lambda self, x, perm: x)
    assert not small_run("atm1_sp8.enwik8_text")["correct"]


def test_megablock_round_returns_its_state(monkeypatch):
    from archon_tpu_torch.parallel import megablock

    def unchanged(*args):
        return lambda rank, k: (rank, torch.ones((), dtype=torch.int32))

    monkeypatch.setattr(megablock, "_make_round_dyn", unchanged)
    assert not small_run("atm1_sp8.enwik8_text")["correct"]


def test_megablock_half_the_shards_left_out(monkeypatch):
    from archon_tpu_torch.parallel import megablock

    sort_rows = megablock.sort_rows

    def half(keys, payloads=()):
        out = sort_rows(keys, payloads)
        rows = keys[0].shape[0]
        unsorted = list(keys) + list(payloads)
        return [torch.cat([o[: rows // 2], u[rows // 2 :]]) for o, u in zip(out, unsorted)]

    monkeypatch.setattr(megablock, "sort_rows", half)
    assert not small_run("atm1_sp8.enwik8_text")["correct"]


def test_compare_holds_every_request():
    from portbench.adapters.encode_file import Adapter

    adapter = Adapter({"generation": "a4", "block_size": 512, "verify": True, "impl": "micro",
                       "pack": False}, "cpu")
    files = [("a", b"banana bandana " * 100), ("b", b"abracadabra " * 50)]
    want = [adapter.reference(d) for _, d in files]
    answers = harness.Answers(adapter, len(files), SEED)
    for i in range(40):
        answers.add(i % 2, want[i % 2])
    assert [len(k) for k in answers.kept] == [harness.KEEP, harness.KEEP]
    assert harness.compare(adapter, files, answers)[1] == 0
    kept = {i for items in answers.kept for i, _ in items}
    other = next(i for i in range(40) if i not in kept and i % 2 == 0)
    bad = bytearray(want[0])
    bad[-1] ^= 1  # the last frame's base
    answers.summaries[other] = (0, adapter.summary(bytes(bad)))
    answers.summaries[1] = (1, None)
    checks, failed = harness.compare(adapter, files, answers)
    assert checks["bad_summary"]["value"] == 1 and checks["requests_raised"]["value"] == 1 and failed == 2


def test_traced_run_counts_fallback_rows(monkeypatch):
    """A traced run of a mix whose every block the batched program leaves
    unresolved (a 1000-byte string planted twice in random bytes): each row
    goes through ``io.blocks._fallback_row``, the run stays correct, and
    ``container.fallback_rows_pct`` reads every row."""
    cell, mix = "a4_micro.planted_repeat", "planted_repeat"
    bench = copy.deepcopy(harness.load_benchmark())
    bench["workloads"].append({"name": cell, "config": "a4_micro", "traffic": mix, "chips": 1, "why": "-"})
    for m in bench["per_layer"]:
        if m["name"] in ("container.fallback_rows_pct", "batched.syncs_per_MiB"):
            m["workloads"].append(cell)
    traffic = {"generator": "files",
               "files": [{"name": "p", "bytes": 32768, "content": "planted_repeat", "unit": 1000}]}
    load = harness.load_traffic
    monkeypatch.setattr(harness, "load_traffic", lambda name: traffic if name == mix else load(name))
    r = harness.run(cell, SEED, 0.2, True, "cpu", bench=bench, call={"block_size": 32768})
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["metrics"]["container.fallback_rows_pct"]["value"] == 100.0
    assert r["device"]["window_s"] > 0 and "breakdown" in r
