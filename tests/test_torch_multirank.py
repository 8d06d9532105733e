"""The distributed layer across ranks, on the CPU: one process a rank,
joined by gloo, 8 row shards in all.

For each world size (1, 2 and 4) the ranks are started once, as torchrun
starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), and ``runtime.initialize()`` opens their group; with
jax and the JAX package made unimportable each rank then runs every job
below and writes its results, which this process holds against the JAX
package's 8-device CPU mesh (``tests/conftest.py``) on the same inputs:

- ``DistEllMatrix`` matvecs of operators from a numpy seed, float64: the
  ranks' blocks together equal the JAX package's y to rel 1e-13, their
  ``to_csr`` rows the padded matrix exactly; ``convert.dist_matrix`` of
  the JAX matrix gives each rank its slice of the JAX shards;
- the three ``dryrun_multichip`` stacks (PCG + AMG, GMRES + MGR,
  BiCGSTAB + block-Jacobi ILU(0)): the JAX package's counts exactly,
  histories to rel 1e-10 with a floor of 1e-12·‖r0‖ (the dots are summed
  per rank, then over the ranks), the same records on every rank;
- PCG + AMS (cycle 1) on the 3-D maxwell_edge_system(8) with every
  operator row-sharded: the JAX package's count on its mesh, and the count
  of world 1, histories to 1e-4·‖r0‖ (the gradient space's dense coarsest
  inverse amplifies rounding, ``test_torch_parallel_precon``);
- a Krylov solve on a wrapped matvec (a lambda): with the mesh's group
  named it reduces over the ranks as the bound matvec does; without it
  it raises on more than one rank;
- ``make_mesh()``: one shard a rank; ``tools/node_scaling`` across the
  ranks: the rows and counts of one process;
- at world 1 the mesh with the group gives the dryrun records of the mesh
  without one, bit for bit.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp

import jax

from hypredrive_tpu.parallel import make_mesh as jax_make_mesh
from hypredrive_tpu.parallel.dist_matrix import DistEllMatrix as JaxDist
from hypredrive_tpu.parallel.dist_matrix import pad_vector as jax_pad
from hypredrive_tpu_torch.ops.csr import (convection_diffusion_2d,
                                          laplacian_3d_7pt)

N_SH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)


def _operators():
    return {"square_lap10": laplacian_3d_7pt(10),
            "padded_lap7": laplacian_3d_7pt(7),       # 343 → 344 rows
            "rectangular": sp.random(96, 24, density=0.2, random_state=0,
                                     format="csr"),
            "asymmetric_convdif": sp.csr_matrix(convection_diffusion_2d(
                16, eps=1e-2, velocity=(4.0, 2.0)))}


# one rank: its jobs, run with jax and the JAX package unimportable
RANK_CODE = textwrap.dedent("""
    import sys
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "hypredrive_tpu"):
                raise ImportError(f"blocked: {name}")
    sys.meta_path.insert(0, Block())
    import os, pickle, resource
    from types import SimpleNamespace
    import numpy as np
    import torch
    import torch.distributed as dist
    import hypredrive_tpu_torch.parallel as par
    from hypredrive_tpu_torch import convert
    from hypredrive_tpu_torch.core import runtime
    from hypredrive_tpu_torch.core.trace import stats
    from hypredrive_tpu_torch.parallel.dryrun import dryrun_multichip
    from hypredrive_tpu_torch.parallel.mesh import Mesh
    from hypredrive_tpu_torch.tools import node_scaling

    torch.set_num_threads(1)
    job_path, out_path = sys.argv[1], sys.argv[2]
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    runtime.initialize()
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = par.make_mesh(8, device="cpu")
    out = {"rank": rank, "world": world, "mesh": (
        mesh.n_shards, mesh.rank, mesh.world, tuple(mesh.shard_range))}
    default = par.make_mesh(device="cpu")
    out["default_mesh"] = (default.n_shards, default.rank, default.world)
    out["matvec"] = {}
    for name, (A, x, J) in job["operators"].items():
        D = par.DistEllMatrix.from_csr(A, mesh)
        xl = par.pad_vector(x, D.shape[1], mesh)
        Dj = convert.dist_matrix(SimpleNamespace(**J), mesh)
        sent = stats["halo_bytes"]
        y = D.matvec(xl).numpy()
        r = {"y": y, "sent": stats["halo_bytes"] - sent,
             "y_jax_shards": Dj.matvec(xl).numpy(),
             "csr": D.to_csr(), "csr_jax_shards": Dj.to_csr(),
             "send_idx": [i.numpy() for i in D.send_idx],
             "n_local_shards": len(D.shards), "l1": D.row_l1_norms().numpy()}
        if A.shape[0] == A.shape[1]:
            r["diag"] = D.diagonal().numpy()
        out["matvec"][name] = r
    out["dryrun"] = dryrun_multichip(mesh)
    from hypredrive_tpu_torch.config.sections import AMS_SCHEMA
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system
    from hypredrive_tpu_torch.precon.ams import _ams_apply, build_ams_state
    from hypredrive_tpu_torch.solvers.pcg import pcg_core
    A, G, xyz = maxwell_edge_system(8, eps=0.05, dim=3)
    st = build_ams_state(A, G, xyz, AMS_SCHEMA.parse({"cycle_type": 1},
                         "ams", []), torch.float64, mesh=mesh)
    b = par.pad_vector(A @ np.random.default_rng(11).uniform(
        -1, 1, A.shape[0]), st.A.shape[0], mesh)
    r = pcg_core(st.A.matvec, lambda r: _ams_apply(st, r), b,
                 torch.zeros_like(b), 1e-8, 0.0, 400, True, 0)
    out["ams"] = (r[1], r[4][:r[1] + 1].tolist())
    from hypredrive_tpu_torch.core.errors import HypredrvError
    D = par.DistEllMatrix.from_csr(job["operators"]["square_lap10"][0], mesh)
    b = par.pad_vector(np.ones(D.shape[0]), D.shape[0], mesh)
    wrapped = {}
    for name, mv, kw in (("bound", D.matvec, {}),
                         ("lambda_group", lambda v: D.matvec(v),
                          {"group": mesh.reduce_group}),
                         ("lambda", lambda v: D.matvec(v), {})):
        try:
            r = pcg_core(mv, lambda v: v, b, torch.zeros_like(b), 1e-8, 0.0,
                         100, True, 0, **kw)
            wrapped[name] = (r[1], r[4][:r[1] + 1].tolist())
        except HypredrvError as e:
            wrapped[name] = str(e)
    out["wrapped"] = wrapped
    if world == 1:
        out["dryrun_no_group"] = dryrun_multichip(Mesh(8, torch.device("cpu")))
    else:
        out["node_scaling"] = node_scaling.run(
            "weak", 216, reps=1, policy="host")
    out["rss_mib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    out["jax_free"] = not any(m.split(".")[0] in ("jax", "hypredrive_tpu")
                              for m in sys.modules)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    runtime.finalize()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_arrays(J) -> dict:
    """The fields of a JAX DistEllMatrix that ``convert.dist_matrix``
    reads, as numpy (a rank process cannot import JAX)."""
    keys = ("shape", "orig_shape", "nnz", "local_max", "ext_size",
            "dia_offsets", "offsets")
    out = {k: getattr(J, k) for k in keys}
    for k in ("dia_data", "cols", "vals", "tail_rows", "tail_cols",
              "tail_vals"):
        v = getattr(J, k)
        out[k] = None if v is None else np.asarray(v)
    out["send_idx"] = tuple(np.asarray(i) for i in J.send_idx)
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's 8-device mesh: each operator's matrix, y and
    shards, and its dryrun stacks (``scripts/jax_goldens.py``)."""
    import importlib.util

    assert jax.device_count() >= N_SH, "tests need the 8-device CPU mesh"
    jmesh = jax_make_mesh(N_SH)
    ops = {}
    for name, A in _operators().items():
        x = np.random.default_rng(7).standard_normal(A.shape[1])
        J = JaxDist.from_csr(A, jmesh)
        y, l1 = jax.jit(lambda J, v: (J.matvec(v), J.row_l1_norms()))(
            J, jax_pad(x, J.shape[1], jmesh))
        ops[name] = (sp.csr_matrix(A), x, J, (np.asarray(y),
                                             np.asarray(l1)))
    spec = importlib.util.spec_from_file_location(
        "jax_goldens", os.path.join(REPO, "scripts", "jax_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stacks = {s["stack"]: s for s in mod.dist_dryrun8()["stacks"]}
    return ops, stacks, _jax_ams(jmesh)


def _jax_ams(jmesh):
    """The JAX package's PCG + AMS (cycle 1) on the rank jobs' 3-D
    Maxwell system and b: (count, history)."""
    import jax.numpy as jnp

    from hypredrive_tpu.config.sections import AMS_SCHEMA
    from hypredrive_tpu.precon.ams import _ams_apply, build_ams_state
    from hypredrive_tpu.solvers.pcg import _pcg_core
    from hypredrive_tpu_torch.ops.csr import maxwell_edge_system

    A, G, xyz = maxwell_edge_system(8, eps=0.05, dim=3)
    sj = build_ams_state(A, G, xyz, AMS_SCHEMA.parse({"cycle_type": 1},
                         "ams", []), jnp.float64, mesh=jmesh)
    b = jax_pad(A @ np.random.default_rng(11).uniform(-1, 1, A.shape[0]),
                sj.A.shape[0], jmesh)

    def run(J, s, b):
        return _pcg_core(J.matvec, lambda r: _ams_apply(s, r), b,
                         jnp.zeros_like(b), 1e-8, 0.0, 400, True, 0)

    out = jax.jit(run)(sj.A, sj, b)
    it = int(out[1])
    return it, np.asarray(out[4])[:it + 1]


_RUNS = {}


def _run_world(world, jax_side, tmp_path_factory):
    """Start ``world`` rank processes (once for each world size); every
    rank's results."""
    if world not in _RUNS:
        _RUNS[world] = _start_ranks(world, jax_side, tmp_path_factory)
    return _RUNS[world]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_side, tmp_path_factory):
    return _run_world(request.param, jax_side, tmp_path_factory)


def _start_ranks(world, jax_side, tmp_path_factory):
    ops = jax_side[0]
    tmp = tmp_path_factory.mktemp(f"world{world}")
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"operators": {n: (A, x, _jax_arrays(J))
                                   for n, (A, x, J, _) in ops.items()}}, f)
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_CODE, str(job), str(tmp / f"{r}.pkl")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + 240
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=max(1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            errors.append(f"rank {r}: timed out\n{err[-2000:]}")
            continue
        if p.returncode != 0:
            errors.append(f"rank {r}: exit {p.returncode}\n{err[-2000:]}")
    assert not errors, "\n".join(errors)
    outs = []
    for r in range(world):
        with open(tmp / f"{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return world, outs


def test_ranks_join_and_hold_their_shards(ranks):
    """Each rank knows its place and holds k = 8 / world consecutive
    shards; make_mesh() defaults to one shard a rank; the ranks ran with
    jax and the JAX package unimportable."""
    world, outs = ranks
    k = N_SH // world
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"]) == (r, world)
        assert o["mesh"] == (N_SH, r, world, tuple(range(r * k, (r + 1) * k)))
        assert o["default_mesh"] == (world, r, world)
        assert o["jax_free"]
        assert all(m["n_local_shards"] == k for m in o["matvec"].values())


@pytest.mark.parametrize("case", sorted(_operators()))
def test_multirank_matvec_matches_jax(ranks, jax_side, case):
    """The ranks' blocks of y, row ℓ1 norms and diagonal, stacked, equal
    the JAX package's 8-device matvec to rel 1e-13 and the host product;
    the ranks' rows of ``to_csr`` are the padded matrix; each rank's send
    indices are its rows of the JAX schedule; halo bytes cross ranks only
    when there is more than one."""
    world, outs = ranks
    A, x, J, (yj, l1j) = jax_side[0][case]
    got = [o["matvec"][case] for o in outs]
    y = np.concatenate([g["y"] for g in got])
    scale = np.abs(yj).max()
    assert np.abs(y - yj).max() <= 1e-13 * scale
    assert np.abs(y[:A.shape[0]] - A @ x).max() <= 1e-13 * scale
    assert np.all(y[A.shape[0]:] == 0.0)
    l1 = np.concatenate([g["l1"] for g in got])
    assert np.abs(l1 - l1j).max() \
        <= 1e-13 * np.abs(l1).max()
    if A.shape[0] == A.shape[1]:
        d = np.concatenate([g["diag"] for g in got])
        assert np.array_equal(d[:A.shape[0]], A.diagonal())
    padded = sp.csr_matrix(A, copy=True)
    padded.resize(J.shape)
    if A.shape[0] == A.shape[1]:
        extra = np.arange(A.shape[0], J.shape[0])
        padded = padded + sp.csr_matrix(
            (np.ones(len(extra)), (extra, extra)), shape=J.shape)
    assert abs(sp.vstack([g["csr"] for g in got]) - padded).max() == 0
    k = N_SH // world
    for r, g in enumerate(got):
        for a, b in zip(g["send_idx"], J.send_idx):
            assert np.array_equal(a, np.asarray(b)[r * k:(r + 1) * k])
        assert (g["sent"] > 0) == (world > 1 and bool(J.offsets))


@pytest.mark.parametrize("case", sorted(_operators()))
def test_convert_gives_each_rank_its_jax_shards(ranks, jax_side, case):
    """``convert.dist_matrix`` of the JAX matrix on a rank holds that
    rank's slice of the JAX shards: its rows equal the port's own, and
    its matvec the JAX package's y to rel 1e-13."""
    _, outs = ranks
    A, x, J, (yj, _) = jax_side[0][case]
    got = [o["matvec"][case] for o in outs]
    for g in got:
        assert abs(g["csr_jax_shards"] - g["csr"]).max() == 0
    y = np.concatenate([g["y_jax_shards"] for g in got])
    assert np.abs(y - yj).max() <= 1e-13 * np.abs(yj).max()


DRYRUN_ITERS = {"pcg_amg": 6, "gmres_mgr": 5, "bicgstab_bj_ilu": 12}


@pytest.mark.parametrize("stack", sorted(DRYRUN_ITERS))
def test_multirank_dryrun_matches_jax(ranks, jax_side, stack):
    """The stack on 8 shards over the ranks: the JAX package's count,
    its history to rel 1e-10 (floor 1e-12·‖r0‖), the same record on
    every rank."""
    _, outs = ranks
    ref = jax_side[1][stack]
    recs = [{s["stack"]: s for s in o["dryrun"]}[stack] for o in outs]
    s = recs[0]
    assert all(r == s for r in recs[1:])
    assert s["converged"] and s["iters"] == ref["iters"] \
        == DRYRUN_ITERS[stack]
    h, hj = np.asarray(s["history"]), np.asarray(ref["history"])
    assert h.shape == hj.shape
    assert np.all(np.abs(h - hj) <= 1e-10 * hj + 1e-12 * hj[0])


def test_world1_group_is_the_mesh_without_one(jax_side, tmp_path_factory):
    """At world 1 the mesh on the process group runs the layer as the
    mesh without a group does: the same records, bit for bit."""
    _, outs = _run_world(1, jax_side, tmp_path_factory)
    o = outs[0]
    assert json.dumps(o["dryrun"]) == json.dumps(o["dryrun_no_group"])


@pytest.mark.parametrize("world", [2, 4], ids=["world2", "world4"])
def test_node_scaling_across_ranks(world, jax_side, tmp_path_factory):
    """``tools/node_scaling`` with its meshes spread over the ranks: the
    rows, nnz and counts of the one-process sweep (which
    ``test_torch_tools.py`` holds against the JAX script)."""
    import contextlib
    import io

    from hypredrive_tpu_torch.tools import node_scaling

    _, outs = _run_world(world, jax_side, tmp_path_factory)
    with contextlib.redirect_stdout(io.StringIO()):
        one = node_scaling.run("weak", 216, reps=1, policy="host")

    def key(rows):
        return [(r["shards"], r["rows"], r["nnz"], r["iters"]) for r in rows]

    assert key(outs[0]["node_scaling"]) == key(one)
    assert [r["ranks"] for r in outs[0]["node_scaling"]] == \
        [min(world, c) for c in node_scaling.SHARD_COUNTS]
    for o in outs[1:]:
        mine = [r for r in outs[0]["node_scaling"] if r["ranks"] > o["rank"]]
        assert key(o["node_scaling"]) == key(mine)


@pytest.mark.parametrize("world", [2, 4], ids=["world2", "world4"])
def test_multirank_ams_matches_world1(world, jax_side, tmp_path_factory):
    """PCG + AMS with its auxiliary hierarchies on the mesh: the count of
    world 1 on every rank, histories to 1e-4·‖r0‖."""
    _, one = _run_world(1, jax_side, tmp_path_factory)
    _, outs = _run_world(world, jax_side, tmp_path_factory)
    it1, h1 = one[0]["ams"]
    h1 = np.asarray(h1)
    for o in outs:
        it, h = o["ams"]
        assert it == it1 and it < 400
        assert np.abs(np.asarray(h) / h[0] - h1 / h1[0]).max() <= 1e-4


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"world{w}")
def test_multirank_ams_matches_jax(world, jax_side, tmp_path_factory):
    """PCG + AMS (cycle 1, 3-D Maxwell) on 8 shards over the ranks: the
    JAX package's 8-device count on every rank, its history to
    1e-4·‖r0‖."""
    it_j, h_j = jax_side[2]
    _, outs = _run_world(world, jax_side, tmp_path_factory)
    for o in outs:
        it, h = o["ams"]
        assert it == it_j
        assert np.abs(np.asarray(h) / h[0] - h_j / h_j[0]).max() <= 1e-4


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"world{w}")
def test_wrapped_matvec_reduces_or_raises(world, jax_side,
                                          tmp_path_factory):
    """PCG on a lambda around the mesh's matvec: with ``group=`` the
    mesh's group it is the solve on the bound matvec, bit for bit, on
    every rank; without it it raises on more than one rank, and at world
    1 (no reduction to miss) it is that solve too."""
    _, outs = _run_world(world, jax_side, tmp_path_factory)
    for o in outs:
        w = o["wrapped"]
        assert w["lambda_group"] == w["bound"] == outs[0]["wrapped"]["bound"]
        assert 0 < w["bound"][0] < 100
        if world > 1:
            assert isinstance(w["lambda"], str) and "group=" in w["lambda"]
        else:
            assert w["lambda"] == w["bound"]
