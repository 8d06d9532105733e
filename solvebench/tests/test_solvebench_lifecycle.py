"""No process a run starts outlives it.  Every process of a run carries a
marker in its environment; none may be alive after a run that ends, one
killed by SIGKILL in the middle of its window, or one stopped by SIGTERM.
A descendant the program leaves behind is killed and reaped before the
last line."""

import os
import signal
import subprocess
import sys
import time
import uuid

import pytest

from solvebench.lifecycle import descendants, reap_descendants
from solvebench.manifest import ROOT
from solvebench.tests import tiny

CELLS = ["poisson128_pcg_amg.steady_rhs", "multiphys64_gmres_mgr.steady_rhs",
         "multiphys64_fgmres_mgr.newton_seq"]


def marked(mark: str):
    """Pids of live processes whose environment holds the marker."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/environ", "rb") as f:
                env = f.read()
            with open(f"/proc/{entry}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if f"SOLVEBENCH_TEST_MARK={mark}".encode() in env and state != "Z":
            found.append(int(entry))
    return found


def gone(mark: str, timeout: float = 30.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if not marked(mark):
            return True
        time.sleep(0.2)
    return not marked(mark)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_leaves_no_process(tmp_path, cell):
    root = tiny.make_root(tmp_path)
    mark = uuid.uuid4().hex
    rc, out, err = tiny.run(root, cell,
                            env=tiny.cpu_env(SOLVEBENCH_TEST_MARK=mark))
    assert rc == 0, err
    assert tiny.last_line(out)["correct"] is True
    assert gone(mark, timeout=5)


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGTERM])
def test_a_stopped_run_leaves_nothing(tmp_path, sig):
    """Stopped in the middle of its window, a run prints no result and
    leaves no process."""
    root = tiny.make_root(tmp_path)
    mark = uuid.uuid4().hex
    p = subprocess.Popen(tiny.command(root, CELLS[0], seconds=60), cwd=ROOT,
                         env=tiny.cpu_env(SOLVEBENCH_TEST_MARK=mark),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        time.sleep(20)
        assert p.poll() is None
        p.send_signal(sig)
        out, _ = p.communicate(timeout=60)
        assert p.returncode != 0 and out.strip() == ""
        assert gone(mark, timeout=5)
    finally:
        p.kill()


def test_a_leftover_descendant_is_reaped():
    """What the program leaves running, a child and its own child, is
    killed before the run's last line."""
    code = ("import subprocess, sys, time; subprocess.Popen([sys.executable,"
            " '-c', 'import time; time.sleep(600)']); time.sleep(600)")
    child = subprocess.Popen([sys.executable, "-c", code])
    end = time.monotonic() + 30
    while len(descendants(os.getpid())) < 2 and time.monotonic() < end:
        time.sleep(0.1)
    pids = descendants(os.getpid())
    assert child.pid in pids and len(pids) >= 2
    assert set(pids) <= set(reap_descendants())
    assert child.poll() is not None
    end = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < end:
        time.sleep(0.1)
    assert not any(_alive(p) for p in pids)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False
