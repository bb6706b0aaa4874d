"""The port's own host modules (native, entropy, golden, config) against the
JAX package's, which they are copies of: same seeded numpy inputs, the same
answers exactly.  Then the three places where the port's ``native`` differs:
the build is safe under racing threads and processes, it lands in the port's
build directory, and ``unbwt_starts`` without a library walks with the
port's torch inverse, never with JAX.

The C++ library must build here (g++ is present wherever the tests run), so
nothing in this file skips without it.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from archon_tpu import config as jconfig
from archon_tpu import native as jnative
from archon_tpu.entropy import huffman as jhuff
from archon_tpu.entropy import order as jorder
from archon_tpu.entropy import pack as jpack
from archon_tpu.golden import sa as jgolden
from archon_tpu.utils.corpus import text_like
from archon_tpu_torch import config as tconfig
from archon_tpu_torch import native as tnative
from archon_tpu_torch.entropy import huffman as thuff
from archon_tpu_torch.entropy import order as torder
from archon_tpu_torch.entropy import pack as tpack
from archon_tpu_torch.golden import sa as tgolden

ROOT = Path(__file__).resolve().parent.parent


def _blocks():
    rng = np.random.default_rng(3)
    return {
        "text": np.frombuffer(text_like(5000, 2), np.uint8),
        "random": rng.integers(0, 256, 3000, dtype=np.uint8),
        "runs": np.repeat(rng.integers(0, 4, 60, dtype=np.uint8), 50),
        "one": np.array([9], np.uint8),
    }


def test_library_is_built_into_the_ports_build_directory():
    from archon_tpu_torch.ops._build import BUILD_DIR

    assert tnative.available(), "g++ must build csrc/archon_host.cpp here"
    assert list(BUILD_DIR.glob("archon_host_*.so"))
    assert tnative._SRC == ROOT / "archon_tpu_torch" / "csrc" / "archon_host.cpp"
    assert tnative._SRC.read_bytes() == (ROOT / "native" / "archon_host.cpp").read_bytes()


@pytest.mark.parametrize("sentinel", ["small", "large"])
def test_unbwt_and_verify_cycle_match(sentinel):
    assert jnative.available() and tnative.available()
    for name, data in _blocks().items():
        L, base = jgolden.bwt_forward(data, sentinel)
        large = sentinel == "large"
        want = jnative.unbwt(L, base, large)
        assert np.array_equal(tnative.unbwt(L, base, large), want), name
        assert np.array_equal(want, data[::-1]), name
        assert np.array_equal(tgolden.bwt_inverse(L, base, sentinel),
                              jgolden.bwt_inverse(L, base, sentinel)), name
        assert tnative.verify_cycle(L, base, large) and jnative.verify_cycle(L, base, large)
        if len(L) > 2:
            bad = L.copy()
            bad[1] = bad[2] = bad[0]
            assert tnative.verify_cycle(bad, base, large) == jnative.verify_cycle(bad, base, large)
    assert np.array_equal(tnative.histogram256(data), jnative.histogram256(data))


def test_golden_forward_and_formats_match():
    for name, data in _blocks().items():
        for sentinel in ("small", "large"):
            assert np.array_equal(tgolden.suffix_array(data, sentinel),
                                  jgolden.suffix_array(data, sentinel)), name
            got, want = tgolden.bwt_forward(data, sentinel), jgolden.bwt_forward(data, sentinel)
            assert np.array_equal(got[0], want[0]) and int(got[1]) == int(want[1]), name
        blob = data.tobytes()
        assert tgolden.a4_encode(blob) == jgolden.a4_encode(blob)
        assert tgolden.a7_encode(blob) == jgolden.a7_encode(blob)
        assert tgolden.a4_decode(tgolden.a4_encode(blob)) == blob
        assert tgolden.a7_decode(tgolden.a7_encode(blob)) == blob


def _var_starts(L):
    counts = np.bincount(L, minlength=256)
    codes = jhuff.build_encoder_var(counts)
    keys = np.array([(codes[c].code << (32 - codes[c].length)) if codes[c].length else -1
                     for c in range(256)], np.int64)
    starts = np.zeros(256, np.int64)
    acc = 0
    for c in np.argsort(keys, kind="stable"):
        starts[c] = acc
        acc += int(counts[c])
    return starts


def test_unbwt_starts_matches_with_and_without_the_library(monkeypatch):
    data = _blocks()["text"]
    L, base = jgolden.bwt_forward(data, "large")
    starts = _var_starts(L)
    want = jnative.unbwt_starts(L, base, starts)
    assert np.array_equal(tnative.unbwt_starts(L, base, starts), want)
    # without a library the port walks with its own torch inverse on the CPU
    monkeypatch.setattr(tnative, "_TRIED", True)
    monkeypatch.setattr(tnative, "_LIB", None)
    assert not tnative.available()
    got = tnative.unbwt_starts(L, base, starts)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    # and the other walks with the golden model
    L4, base4 = jgolden.bwt_forward(data, "small")
    assert np.array_equal(tnative.unbwt(L4, base4, False), data[::-1])
    assert tnative.verify_cycle(L4, base4, False)


def _codes(table):
    return [(c.code, c.length) for c in table]


def test_huffman_tables_match():
    rng = np.random.default_rng(5)
    freqs = [np.bincount(b, minlength=256) for b in _blocks().values()]
    freqs.append(rng.integers(0, 1000, 256))
    freqs.append(np.ones(256, np.int64))
    assert _codes(thuff.build_encoder_byte()) == _codes(jhuff.build_encoder_byte())
    for f in freqs:
        assert _codes(thuff.build_encoder_var(f)) == _codes(jhuff.build_encoder_var(f))
        got, want = thuff.build_encoder_fixed(f), jhuff.build_encoder_fixed(f)
        assert _codes(got[0]) == _codes(want[0]) and got[1] == want[1]
        weights = [int(x) for x in f if x]
        assert _codes(thuff.huff_compute(weights)) == _codes(jhuff.huff_compute(weights))


@pytest.mark.parametrize("order", sorted(jorder.ORDER_FUNCTIONS))
def test_order_table_matches(order):
    assert sorted(torder.ORDER_FUNCTIONS) == sorted(jorder.ORDER_FUNCTIONS)
    for name, data in _blocks().items():
        got, want = torder.order_table(data, order), jorder.order_table(data, order)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    with pytest.raises(ValueError):
        torder.order_table(data, "nope")


def test_mtf_rle0_and_bit_codecs_match():
    for name, data in _blocks().items():
        L, _ = jgolden.bwt_forward(data, "small")
        syms = jnative.mtf_rle0(L)
        assert np.array_equal(tnative.mtf_rle0(L), syms), name
        assert np.array_equal(tnative._mtf_rle0_py(L), syms), name
        assert np.array_equal(tnative.unrle0_unmtf(syms, len(L)), L), name
        assert np.array_equal(tnative._unrle0_unmtf_py(syms, len(L)), L), name
        # the 257-ary codec of the packed container
        hist = np.bincount(syms, minlength=tpack.NSYM)
        present = np.nonzero(hist)[0]
        vals, lens, maxlen = tpack._codes_for(present, hist[present])
        jvals, jlens, jmaxlen = jpack._codes_for(present, hist[present])
        assert np.array_equal(vals, jvals) and np.array_equal(lens, jlens) and maxlen == jmaxlen
        words, nbits = tnative.bitpack16(syms, vals, lens)
        jwords, jnbits = jnative.bitpack16(syms, vals, lens)
        assert nbits == jnbits and np.array_equal(words, jwords), name
        pwords, pbits = tnative._bitpack16_py(syms, vals, lens)
        assert pbits == nbits and np.array_equal(pwords[: (nbits + 31) // 32],
                                                 words[: (nbits + 31) // 32]), name
        if len(present) > 1:
            assert np.array_equal(tnative.bitunpack16(words, nbits, vals, lens, len(syms)), syms)
        # the a6 byte codec
        codes = jhuff.build_encoder_var(np.bincount(data, minlength=256))
        cv = np.array([c.code for c in codes], np.uint32)
        cl = np.array([c.length for c in codes], np.uint8)
        if cl.max() > 0 and len(data) > 1:
            w, bits = tnative.bitpack(data, cv, cl)
            jw, jbits = jnative.bitpack(data, cv, cl)
            assert bits == jbits and np.array_equal(w, jw), name
            assert np.array_equal(tnative.bitunpack(w, bits, cv, cl, len(data)),
                                  jnative.bitunpack(jw, jbits, cv, cl, len(data))), name


def test_pack_block_bytes_match():
    rng = np.random.default_rng(8)
    cases = dict(_blocks(), empty=np.zeros(0, np.uint8),
                 incompressible=rng.integers(0, 256, 300, dtype=np.uint8))
    for name, data in cases.items():
        L = jgolden.bwt_forward(data, "small")[0] if len(data) else data
        want = jpack.pack_block(L)
        got = tpack.pack_block(L)
        assert got == want, name
        assert np.array_equal(tpack.unpack_block(got, len(L)), L), name
    with pytest.raises(ValueError):
        tpack.unpack_block(b"\x07", 3)


def test_config_has_the_same_fields_and_defaults():
    want = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfig.ArchonConfig)]
    got = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfig.ArchonConfig)]
    assert got == want
    cfg = tconfig.ArchonConfig(generation="a7", pack=True)
    assert cfg.to_dict() == jconfig.ArchonConfig(generation="a7", pack=True).to_dict()
    assert tconfig.ArchonConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.sentinel() == "large" and tconfig.ArchonConfig().sentinel() == "small"


def test_mapped_file_reads_blocks(tmp_path):
    data = text_like(3000, 4)
    path = tmp_path / "in.bin"
    path.write_bytes(data)
    with tnative.MappedFile(str(path)) as mf:
        assert bytes(mf.data) == data
        assert [bytes(b) for b in mf.blocks(1024)] == [data[i:i + 1024] for i in range(0, 3000, 1024)]


_RACE = """
import sys, threading
from pathlib import Path
from archon_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])  # before native imports it
from archon_tpu_torch import native
assert native.BUILD_DIR == _build.BUILD_DIR
threads = int(sys.argv[2])
got = [None] * threads
gate = threading.Barrier(threads)
def call(i):
    gate.wait()
    got[i] = native.available()
ts = [threading.Thread(target=call, args=(i,)) for i in range(threads)]
[t.start() for t in ts]
[t.join() for t in ts]
assert all(got), got
import numpy as np
L = np.frombuffer(b"annbaa", np.uint8)
assert native._LIB is not None and native.mtf_rle0(L).dtype == np.uint16
assert "jax" not in sys.modules and not any(m.split(".")[0] == "archon_tpu" for m in sys.modules)
print("ok", len(list(_build.BUILD_DIR.glob("*.so"))), len(list(_build.BUILD_DIR.glob("*.tmp"))))
"""


def test_build_is_safe_under_racing_threads(tmp_path):
    """A fresh interpreter, an empty build directory, 8 threads calling
    ``available()`` at once: every one gets the library, built once."""
    proc = subprocess.run([sys.executable, "-c", _RACE, str(tmp_path), "8"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["ok", "1", "0"]


def test_build_is_safe_under_racing_processes(tmp_path):
    """4 fresh interpreters racing on one empty build directory: each
    compiles to a name of its own and renames, so every one loads a whole
    library and one file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path), "2"], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        assert out.split()[0] == "ok"
    assert len(list(tmp_path.glob("archon_host_*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))
