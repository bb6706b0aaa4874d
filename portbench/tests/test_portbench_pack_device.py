"""Faults planted in the device pack (``entropy.pack.RowPack``, the path of
every row the batched program resolves on the card) come out not correct in
the cell ``a4_micro_pack.silesia_text`` run small on the CPU with its units
packed as on a card, and the cell reads ``pack.device_pct``."""

import numpy as np
import pytest

from archon_tpu_torch.entropy import pack
from archon_tpu_torch.io import blocks
from portbench import harness

CELL = "a4_micro_pack.silesia_text"
SEED = 2**31 + 101
SCALE, CALL = 1024, {"block_size": 8192}


@pytest.fixture(autouse=True)
def packs_as_on_a_card(monkeypatch):
    monkeypatch.setattr(blocks, "_packs_on_device", lambda L: True)


def small_run(trace=False):
    return harness.run(CELL, SEED, 0.2, trace, "cpu", scale=SCALE, call=CALL)


def test_every_row_packs_on_the_device_path():
    r = small_run(trace=True)
    assert r["correct"] and r["metrics"]["pack.device_pct"]["value"] == 100.0
    assert {"pack.core_MBps", "pack.ratio_pct", "pack.idle_pct"} <= set(r["metrics"])


def test_payload_byte_altered_on_the_device_path_is_caught(monkeypatch):
    payloads = pack.RowPack.payloads

    def altered(self, rows):
        out = [bytearray(p) for p in payloads(self, rows)]
        out[0][-1] ^= 1  # one byte of a payload altered where it is produced
        return [bytes(p) for p in out]

    monkeypatch.setattr(pack.RowPack, "payloads", altered)
    r = small_run()
    assert not r["correct"] and r["checks"]["bad_frame_payload"]["value"] >= 1


def test_packable_row_stored_raw_on_the_device_path_is_caught(monkeypatch):
    def raw(self, rows):
        return [b"\x00" + np.ascontiguousarray(self._L[r].numpy()).tobytes() for r in rows]

    monkeypatch.setattr(pack.RowPack, "payloads", raw)
    r = small_run()
    assert not r["correct"] and r["checks"]["bad_frame_payload"]["value"] >= 1
