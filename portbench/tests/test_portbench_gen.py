"""The traffic generator: sizes, order and determinism per seed."""

import json
from pathlib import Path

import pytest

from portbench.gen import files
from portbench.gen.fibonacci import fibonacci_string

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
BIG_SEED = 2**31 + 12345  # seeds may exceed 32 signed bits


@pytest.mark.parametrize("mix", sorted(p.stem for p in TRAFFIC.glob("*.json")))
def test_sizes_order_and_determinism(mix):
    traffic = json.loads((TRAFFIC / f"{mix}.json").read_text())
    scale = 4096
    a = files.make(traffic, BIG_SEED, scale)
    assert a == files.make(traffic, BIG_SEED, scale)
    assert [name for name, _ in a] == [f["name"] for f in traffic["files"]]
    assert [len(d) for _, d in a] == [max(1, f["bytes"] // scale) for f in traffic["files"]]
    b = files.make(traffic, BIG_SEED + 1, scale)
    assert [len(d) for _, d in b] == [len(d) for _, d in a]
    if any(f["content"] != "fibonacci" for f in traffic["files"]):
        assert a != b


def test_published_sizes():
    sizes = {p.stem: [f["bytes"] for f in json.loads(p.read_text())["files"]] for p in TRAFFIC.glob("*.json")}
    assert sum(sizes["silesia_text"]) == 211_938_580 and len(sizes["silesia_text"]) == 12
    assert len(sizes["canterbury_small"]) == 11 and max(sizes["canterbury_small"]) == 1_029_744
    assert sizes["gauntlet"] == [15_375_420, 956_320, 14_930_352]
    assert sizes["enwik8_text"] == [100_000_000]


def test_contents():
    traffic = {"files": [{"name": "t", "bytes": 5000, "content": "zipf_text"},
                         {"name": "r", "bytes": 5000, "content": "repeat", "unit": 300},
                         {"name": "f", "bytes": 5000, "content": "fibonacci"}]}
    (_, t), (_, r), (_, f) = files.make(traffic, 7)
    assert set(t) <= set(b"abcdefghijklmnopqrstuvwxyz .,\n")
    assert r == (r[:300] * 17)[:5000]
    assert f == fibonacci_string(5000) and f.startswith(b"abaababaabaab")
    (_, p), = files.make({"files": [{"name": "p", "bytes": 8000, "content": "planted_repeat", "unit": 900,
                                     "span": 4000}]}, 7)
    assert len(p) == 8000 and p[500:1400] == p[2000:2900] == p[4500:5400] == p[6000:6900]
    assert len(set(p[:500])) > 200  # random bytes around the repeats
    with pytest.raises(ValueError):
        files.make({"files": [{"name": "x", "bytes": 10, "content": "nope"}]}, 1)
