"""The port's readers under the fuzz tier, on the CPU.

- Every saved fuzz regression -- the JAX package's corpus
  (``tests/fuzz_corpus/<mode>/``, all four modes) and the port's own
  (``tests/fuzz_corpus_torch/<mode>/``, where
  ``hypredrive_tpu_torch/tools/fuzz_loop.py`` saves what it finds) --
  goes through the tool's ``TARGETS`` and raises typed errors only.
- A seeded 2 s run of the tool over all five modes finds no crash.
- A crash the loop finds is minimized and saved under the port's corpus
  directory, never the JAX package's.
"""

import contextlib
import io
import os

import pytest

from hypredrive_tpu_torch.core.errors import ConfigError, HypredrvError
from hypredrive_tpu_torch.tools import fuzz_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpus_cases():
    cases = []
    for root in ("fuzz_corpus", "fuzz_corpus_torch"):
        base = os.path.join(REPO, "tests", root)
        if not os.path.isdir(base):
            continue
        for mode in sorted(os.listdir(base)):
            d = os.path.join(base, mode)
            cases += [(mode, os.path.join(d, name))
                      for name in sorted(os.listdir(d))]
    return cases


@pytest.mark.parametrize(
    "mode,path", _corpus_cases(),
    ids=lambda v: os.path.relpath(v, os.path.join(REPO, "tests"))
    if os.sep in str(v) else str(v))
def test_replay_fuzz_corpus_typed_only(mode, path):
    with open(path, "rb") as f:
        data = f.read()
    try:
        fuzz_loop.TARGETS[mode](data)
    except (HypredrvError, ConfigError):
        pass        # typed rejection is the contract


def test_corpus_covers_every_mode_of_the_jax_tier():
    modes = {m for m, _ in _corpus_cases()}
    assert {"comp", "lsseq", "matrix", "parse"} <= modes
    assert len([p for _, p in _corpus_cases()
                if f"{os.sep}fuzz_corpus{os.sep}" in p]) == 24


def test_seeded_fuzz_run_finds_no_crash(monkeypatch, tmp_path):
    monkeypatch.setattr(fuzz_loop, "CORPUS_DIR", str(tmp_path))
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc = fuzz_loop.main(["--seconds", "2", "--seed", "0",
                             "--exec-policy", "host"])
    out = buf.getvalue()
    assert rc == 0, out
    assert out.count("crashes=0") == len(fuzz_loop.TARGETS)
    assert "OK: no crashes" in out
    assert os.listdir(tmp_path) == []


def test_crash_is_minimized_into_the_port_corpus(monkeypatch, tmp_path):
    def brittle(data):
        if b"\xff" in data:
            raise IndexError("untyped")
        raise HypredrvError("typed")

    monkeypatch.setitem(fuzz_loop.TARGETS, "comp", brittle)
    monkeypatch.setattr(fuzz_loop, "CORPUS_DIR", str(tmp_path))
    monkeypatch.setattr(fuzz_loop, "make_seeds",
                        lambda mode: [b"ok", b"abc\xffdef"])
    import random

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        crashes = fuzz_loop.run_mode("comp", 0.2, random.Random(0))
    assert crashes >= 1
    saved = os.listdir(tmp_path / "comp")
    assert saved and "crash saved" in buf.getvalue()
    for name in saved:
        data = (tmp_path / "comp" / name).read_bytes()
        assert data.endswith(b"\xff") and len(data) <= 4
