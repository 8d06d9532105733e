"""The port's sequence containers (lsseq), codecs and offline tools against
the JAX package's, on the CPU.

A container packed by either package reads back bit for bit in the other;
the port's readers reject the malformed inputs the JAX package's fuzz tier
rejects (tests/test_fuzz.py), with typed errors only; ex7 runs from a
packed container through ``sequence_filename`` with the JAX package's
counts.
"""

import os
import re
import sys

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from hypredrive_tpu.io import lsseq as jax_lsseq
from hypredrive_tpu_torch import cli
from hypredrive_tpu_torch.api import HypreDrive
from hypredrive_tpu_torch.core.errors import ErrorCode, HypredrvError
from hypredrive_tpu_torch.io import comp, ij, lsseq
from hypredrive_tpu_torch.tools import lsseq as lsseq_cli
from hypredrive_tpu_torch.tools import mat2ijbin

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = [("general:exec_policy", "host"), ("general:statistics", "off")]
POROSEQ = os.path.join(REPO, "data", "poroseq", "np1")
# the JAX package's counts for examples/ex7.yml (tests/test_torch_slice_seq.py)
JAX_ITERS_EX7 = (12, 21, 8, 12, 21, 8, 12, 21)


def _systems():
    """Three small systems sharing one pattern, a fourth with another."""
    rng = np.random.default_rng(3)
    A = sp.csr_matrix(sp.random(40, 40, 0.1, random_state=5)
                      + 4 * sp.identity(40))
    out = []
    for k in range(3):
        B = A.copy()
        B.data = B.data * (1.0 + 0.1 * k)
        out.append({"A": B, "b": rng.uniform(-1, 1, 40),
                    "dofmap": np.arange(40) % 2})
    out.append({"A": sp.csr_matrix(sp.identity(40) * 2.0),
                "b": np.ones(40), "dofmap": np.arange(40) % 2})
    return out


def _assert_same_container(read, systems):
    assert read.num_systems == len(systems)
    for k, s in enumerate(systems):
        A = read.read_matrix(k)
        assert (abs(A - s["A"]) > 0).nnz == 0
        np.testing.assert_array_equal(read.read_rhs(k), s["b"])
        np.testing.assert_array_equal(read.read_dofmap(k), s["dofmap"])


CODECS = ["none", "zlib", "lz4", "lz4hc", "blosc", "zstd"]


@pytest.mark.parametrize("codec", CODECS)
def test_containers_cross_read(codec, tmp_path):
    """Written by the port, read by the JAX package, and the reverse."""
    if codec == "zstd":
        pytest.importorskip("zstandard")
    systems = _systems()
    cid = comp.codec_from_name(codec)
    ours, theirs = str(tmp_path / "t.lsseq"), str(tmp_path / "j.lsseq")
    lsseq.write_lsseq(ours, systems, codec=cid,
                      timesteps=[(0, 0), (1, 2)])
    jax_lsseq.write_lsseq(theirs, systems, codec=cid,
                          timesteps=[(0, 0), (1, 2)])
    for path in (ours, theirs):
        _assert_same_container(lsseq.LSSeqFile(path), systems)
        _assert_same_container(jax_lsseq.LSSeqFile(path), systems)
        f = lsseq.LSSeqFile(path)
        assert f.read_timesteps() == [(0, 0), (1, 2)]
        assert f.pattern_id(0) == f.pattern_id(2) != f.pattern_id(3)
    for k in range(len(systems)):
        blob = comp.compress(cid, systems[k]["b"].tobytes())
        assert comp.decompress(cid, blob) == systems[k]["b"].tobytes()


def test_zstd_absent_raises_typed(monkeypatch):
    """The card's machine has no zstandard: a zstd blob is a typed
    NOT_IMPLEMENTED error there, never an import failure."""
    monkeypatch.setitem(sys.modules, "zstandard", None)
    for fn, blob in ((comp.compress, b"abc"),
                     (comp.decompress, b"\x03" + b"\x00" * 7 + b"xyz")):
        with pytest.raises(HypredrvError) as exc:
            fn(comp.COMP_ZSTD, blob)
        assert exc.value.code == ErrorCode.NOT_IMPLEMENTED


def test_pack_unpack_round_trip(tmp_path):
    """tools/lsseq pack → inspect → unpack on the poroseq systems."""
    out = str(tmp_path / "poro.lsseq")
    pat = os.path.join(POROSEQ, "ls_%05d", "{}")
    # the tool takes "timestep first-system" rows, without the count line
    # of a timestep_filename file
    ts = tmp_path / "timesteps.txt"
    ts.write_text("".join(open(os.path.join(POROSEQ, "timesteps.txt"))
                          .readlines()[1:]))
    assert lsseq_cli.main(["pack", out, "-m", pat.format("IJ.out.A"),
                           "-r", pat.format("IJ.out.b"),
                           "-d", pat.format("dofmap.out"), "--codec", "zlib",
                           "--parts", "2", "--timesteps", str(ts),
                           "--info", "case=poroseq"]) == 0
    assert lsseq_cli.main(["inspect", out, "-v"]) == 0
    f = lsseq.LSSeqFile(out)
    assert f.num_systems == 8 and f.info["case"] == "poroseq"
    assert f.read_timesteps() == [(0, 0), (1, 2), (2, 4), (3, 6)]
    outdir = tmp_path / "unpacked"
    assert lsseq_cli.main(["unpack", out, str(outdir)]) == 0
    for k in range(8):
        A, _ = ij.read_matrix_auto(pat.format("IJ.out.A") % k)
        R, _ = ij.read_matrix_auto(str(outdir / f"IJ.out.A.{k:05d}"))
        assert (abs(R - A) > 1e-14).nnz == 0
        np.testing.assert_array_equal(
            ij.read_vector_auto(str(outdir / f"IJ.out.b.{k:05d}")),
            ij.read_vector_auto(pat.format("IJ.out.b") % k))
    assert lsseq_cli.main(["pack", str(tmp_path / "x.lsseq"), "-m",
                           str(tmp_path / "missing.%05d")]) == 1


@pytest.fixture
def valid_lsseq(tmp_path):
    A = sp.identity(8, format="csr") * 2.0
    path = str(tmp_path / "seq.lsseq")
    lsseq.write_lsseq(path, [{"A": A, "b": np.ones(8)},
                             {"A": A * 1.5, "b": np.zeros(8)}])
    return path


def _rewrite(path, fn):
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    out = path + ".mut"
    with open(out, "wb") as f:
        f.write(fn(raw))
    return out


def _bad_magic(raw):
    raw[0:8] = b"NOTMAGIC"
    return raw


def _flip_blob(raw):
    # the last 64 bytes, inside the last compressed blob (the JAX package's
    # one-byte probe at byte 96 lands in padding here, and its test skips)
    raw[-64:] = bytes(b ^ 0xFF for b in raw[-64:])
    return raw


@pytest.mark.parametrize("case", ["bad_magic", "truncated",
                                  "corrupt_blob", "out_of_range"])
def test_lsseq_rejections(case, valid_lsseq):
    """tests/test_fuzz.py's lsseq rejections on the port's reader."""
    with pytest.raises(HypredrvError):
        if case == "bad_magic":
            lsseq.LSSeqFile(_rewrite(valid_lsseq, _bad_magic))
        elif case == "truncated":
            lsseq.LSSeqFile(_rewrite(valid_lsseq, lambda raw: raw[:40]))
        elif case == "corrupt_blob":
            f = lsseq.LSSeqFile(_rewrite(valid_lsseq, _flip_blob))
            for k in range(f.num_systems):
                f.read_matrix(k)
                f.read_rhs(k)
        else:
            lsseq.LSSeqFile(valid_lsseq).read_matrix(99)


def _corpus(mode):
    d = os.path.join(REPO, "tests", "fuzz_corpus", mode)
    return [(mode, os.path.join(d, n)) for n in sorted(os.listdir(d))]


@pytest.mark.parametrize("mode,path", _corpus("comp") + _corpus("lsseq"))
def test_fuzz_corpus_typed_only(mode, path, tmp_path):
    """The saved comp and lsseq fuzz regressions raise typed errors only
    in the port's codecs and reader."""
    data = open(path, "rb").read()
    if mode == "comp":
        for codec in (comp.COMP_ZLIB, comp.COMP_LZ4, comp.COMP_BLOSC):
            try:
                comp.decompress(codec, data)
            except HypredrvError:
                pass
        return
    p = str(tmp_path / "s.bin")
    with open(p, "wb") as f:
        f.write(data)
    try:
        r = lsseq.LSSeqFile(p)
        if r.num_systems:
            r.read_matrix(0)
    except HypredrvError:
        pass


def _ex7_from(container, tmp_path):
    text = open(os.path.join(REPO, "examples", "ex7.yml")).read()
    text = re.sub(r"linear_system:\n(  .*\n)+",
                  f"linear_system:\n  sequence_filename: {container}\n", text)
    path = tmp_path / "ex7-lsseq.yml"
    path.write_text(text)
    return str(path)


def test_ex7_through_sequence_filename(tmp_path):
    """ex7's eight poroseq systems from a zlib container: the system count
    comes from the container, and every count is the JAX package's."""
    out = str(tmp_path / "poro.lsseq")
    pat = os.path.join(POROSEQ, "ls_%05d", "{}")
    assert lsseq_cli.main(["pack", out, "-m", pat.format("IJ.out.A"),
                           "-r", pat.format("IJ.out.b"),
                           "-d", pat.format("dofmap.out"),
                           "--codec", "zlib"]) == 0
    collect = []
    assert cli.run_one_config(_ex7_from(out, tmp_path), overrides=HOST,
                              collect=collect) == 0
    entries = collect[0].stats.entries
    assert tuple(e.iters for e in entries) == JAX_ITERS_EX7
    assert all(e.converged and e.rel_res_norm <= 1e-6 for e in entries)


def test_timestep_table_from_container(tmp_path):
    """A container's timestep table feeds the driver's schedule."""
    path = str(tmp_path / "ts.lsseq")
    lsseq.write_lsseq(path, _systems(), timesteps=[(0, 0), (1, 2)])
    drv = HypreDrive()
    drv.input_args_from_dict({"general": {"exec_policy": "host"},
                              "linear_system": {"sequence_filename": path},
                              "solver": "gmres", "preconditioner": "jacobi"})
    assert drv._timestep_schedule == [(0, 0), (1, 2)]
    for k in range(4):
        s = drv.linear_system_build()
        assert s.pattern_id == lsseq.LSSeqFile(path).pattern_id(k)
        np.testing.assert_array_equal(s.dofmap, np.arange(40) % 2)
    assert drv._timestep_index(3) == 1


def test_mat2ijbin_mtx_to_ij_binary(tmp_path):
    """The .mtx → IJ-binary converter, read back by the port's reader."""
    A = sp.csr_matrix(sp.random(30, 30, 0.15, random_state=3)
                      + 30 * sp.identity(30))
    mtx = str(tmp_path / "A.mtx")
    scipy.io.mmwrite(mtx, A)
    prefix = str(tmp_path / "IJ.A")
    assert mat2ijbin.main([mtx, prefix, "--parts", "2"]) == 0
    B, _ = ij.read_matrix_auto(prefix)
    assert (abs(B - A) > 1e-14).nnz == 0
