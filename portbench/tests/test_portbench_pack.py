"""The cell ``a4_micro_pack.silesia_text`` run small on the CPU: the program
is correct, the control is not, and faults planted in the pack, in the
timed path, come out not correct."""

import numpy as np

from archon_tpu_torch.io import blocks
from portbench import control, harness

CELL = "a4_micro_pack.silesia_text"
SEED = 2**31 + 99
SCALE, CALL = 1024, {"block_size": 8192}


def small_run():
    return harness.run(CELL, SEED, 0.2, False, "cpu", scale=SCALE, call=CALL)


def test_program_is_correct():
    r = small_run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert "bad_frame_payload" in r["checks"] and all(c["value"] == 0 for c in r["checks"].values())


def test_control_is_not_correct():
    out = control.control_checks(CELL, SEED, "cpu", SCALE, CALL)
    assert not out["correct"] and out["checks"]["bad_frame_payload"]["value"] >= 1


def test_payload_byte_altered_is_caught(monkeypatch):
    pack_block = blocks.pack_block

    def altered(L):
        p = bytearray(pack_block(L))
        p[-1] ^= 1  # one byte of the payload altered where it is produced
        return bytes(p)

    monkeypatch.setattr(blocks, "pack_block", altered)
    r = small_run()
    assert not r["correct"] and r["checks"]["bad_frame_payload"]["value"] >= 1


def test_packable_block_stored_raw_is_caught(monkeypatch):
    def raw(L):
        return b"\x00" + np.ascontiguousarray(L, np.uint8).tobytes()

    monkeypatch.setattr(blocks, "pack_block", raw)
    r = small_run()
    assert not r["correct"] and r["checks"]["bad_frame_payload"]["value"] >= 1
