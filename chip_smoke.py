#!/usr/bin/env python3
"""Smoke test of hypredrive_tpu_torch on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit, CUDA, ``nvcc``; build the
   CUDA kernels from ``hypredrive_tpu_torch/csrc`` (timed).
2. Kernels against their plain torch versions on the card, at the shapes
   of the 128³ solve: the fine-grid DIA operator, and the CSR remainders of
   P, R and the first coarse A of its AMG hierarchy; float32 (rel 1e-5) and
   float64 (rel 1e-12).  Kernel and plain times from CUDA events.
3. examples/ex1.yml through ``hypredrive_tpu_torch.cli`` on the card in
   float64: 5 iterations, relative residual ≤ 1e-6, and the solution
   checked against scipy on the host.
4. A 64³ Laplacian, PCG + AMG to 1e-8 in float32 through the driver API:
   10 ± 1 iterations over 6 levels.
5. A 128³ Laplacian (2,097,152 rows, 14,581,760 nnz), PCG + AMG to 1e-8 in
   float64: within ±1 iteration of the JAX package's count.
6. Both kernels' launch counters, zeroed before phase 3, are > 0 after
   phase 5.

Prints the kernel table as one JSON line, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``.  Details go to
``build/chip_smoke.json``.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# JAX package on the same 128³ problem (b = ones, x0 = 0, rtol 1e-8,
# float64), run on the CPU (PERF.md): iterations and PCG residual history
JAX_ITERS_128_F64 = 11
JAX_HISTORY_128_F64 = (
    1448.1546878700494, 3293.653967152578, 788.7789979336529,
    125.22490932459208, 17.11869182232035, 1.9396181274406765,
    0.2167578676005322, 0.02780726807465523, 0.004338904608680726,
    0.00060304664419422, 6.900813139053883e-05, 8.635607504721512e-06)

GOLDEN_EX1_ITERS = 5          # tests/test_examples.py GOLDEN["ex1.yml"]
JAX_ITERS_64_F32 = 10         # JAX package's 64³ float32 count
JAX_LEVELS_64 = 6


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_ms(fn, reps=50, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_env(report):
    import torch
    from hypredrive_tpu_torch.ops import kernels
    from hypredrive_tpu_torch.io import native

    report["nvidia_smi"] = nvidia_smi()
    report["torch"] = torch.__version__
    report["torch_cuda"] = torch.version.cuda
    nvcc = kernels.find_nvcc()
    check(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report["nvcc"] = ver[-1] if ver else ""
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, nvcc: {report['nvcc']}")
    t0 = time.perf_counter()
    kernels.lib()
    report["kernel_build_s"] = time.perf_counter() - t0
    print(f"kernel build + load: {report['kernel_build_s']:.3f} s "
          f"({kernels.BUILD_ROOT})")
    t0 = time.perf_counter()
    report["host_helpers"] = native.backend()
    print(f"AMG host setup helpers: {report['host_helpers']} "
          f"({time.perf_counter() - t0:.3f} s)")


def phase_kernels(report):
    """Each kernel against its plain version at the 128³ solve's shapes."""
    import numpy as np
    import torch
    from hypredrive_tpu_torch.config.sections import AMG_SCHEMA
    from hypredrive_tpu_torch.ops.csr import laplacian_3d_7pt
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv, csr_spmv_plain
    from hypredrive_tpu_torch.ops.device_matrix import EllMatrix
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_plain
    from hypredrive_tpu_torch.precon.amg.hierarchy import setup_hierarchy

    dev = torch.device("cuda")
    A_host = laplacian_3d_7pt(128)
    t0 = time.perf_counter()
    A = EllMatrix.from_csr(A_host, dtype=torch.float64, device=dev)
    state = setup_hierarchy(A_host, AMG_SCHEMA.defaults(),
                            dtype=torch.float64, device=dev, fine_matrix=A)
    print(f"128^3 hierarchy for the kernel checks: "
          f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    rows = []

    def compare(name, shape_name, dt, run, plain, n_x):
        x = torch.as_tensor(rng.standard_normal(n_x), dtype=dt, device=dev)
        y = run(x)
        yp = plain(x)
        torch.cuda.synchronize()
        err = float((y - yp).abs().max())
        scale = float(yp.abs().max()) or 1.0
        rel = err / scale
        ms = time_ms(lambda: run(x))
        plain_ms = time_ms(lambda: plain(x))
        row = {"kernel": name, "shape": shape_name,
               "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol[dt],
               "ms": ms, "plain_ms": plain_ms}
        rows.append(row)
        print(f"  {name:9s} {shape_name:34s} {row['dtype']:8s} "
              f"rel {rel:.3e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        check(np.isfinite(rel) and rel <= tol[dt],
              f"{name} {shape_name} {dt}: rel err {rel:.3e} > {tol[dt]}")

    lv0, lv1 = state.levels[0], state.levels[1]
    csr_ops = [(f"P0 {lv0.P.shape[0]}x{lv0.P.shape[1]}", lv0.P),
               (f"R0 {lv0.R.shape[0]}x{lv0.R.shape[1]}", lv0.R),
               (f"A1 {lv1.A.shape[0]}x{lv1.A.shape[1]}", lv1.A)]
    for dt in (torch.float64, torch.float32):
        dia = A.dia_data.to(dt)
        offs = A.dia_offsets
        n = A.shape[0]
        compare("dia_spmv", f"A0 {n}x{n} D={len(offs)}", dt,
                lambda x: dia_spmv(dia, offs, x, n),
                lambda x: dia_spmv_plain(dia, offs, x, n), n)
        for shape_name, E in csr_ops:
            check(E.data is not None, f"{shape_name} has no CSR remainder")
            data = E.data.to(dt)
            nr, nc = E.shape
            compare("csr_spmv", f"{shape_name} nnz={E.data.numel()}", dt,
                    lambda x: csr_spmv(E.indptr, E.indices, data, x, nr,
                                       E.group),
                    lambda x: csr_spmv_plain(E.indptr, E.indices, data, x,
                                             nr), nc)
    report["kernel_checks"] = rows
    del state, A
    torch.cuda.empty_cache()


def phase_ex1(report):
    import numpy as np
    import scipy.sparse.linalg as spla
    import hypredrive_tpu_torch
    from hypredrive_tpu_torch import cli
    from hypredrive_tpu_torch.io import ij

    collect = []
    rc = cli.run_one_config(os.path.join("examples", "ex1.yml"),
                            overrides=[("general:print_config_params",
                                        "off")],
                            collect=collect)
    check(rc == 0, f"ex1: cli returned {rc}")
    drv = collect[0]
    (e,) = drv.stats.entries
    report["ex1"] = {"iters": e.iters, "rel_res_norm": e.rel_res_norm,
                     "setup_s": e.setup_time, "solve_s": e.solve_time}
    check(e.iters == GOLDEN_EX1_ITERS,
          f"ex1: {e.iters} iterations, expected {GOLDEN_EX1_ITERS}")
    check(e.converged and e.rel_res_norm <= 1e-6,
          f"ex1: relative residual {e.rel_res_norm:.3e} > 1e-6")
    # the same config through the one-shot API, for the solution vector
    res = hypredrive_tpu_torch.solve(config=os.path.join("examples",
                                                         "ex1.yml"))
    check(res.iters == GOLDEN_EX1_ITERS,
          f"ex1 via solve(): {res.iters} iterations")
    x = res.x
    A_host, _ = ij.read_matrix_auto("data/ps3d10pt7/np1/IJ.out.A")
    b = ij.read_vector_auto("data/ps3d10pt7/np1/IJ.out.b")
    check(x.shape == (A_host.shape[0],) and np.all(np.isfinite(x)),
          "ex1: solution not finite or of the wrong shape")
    host_rel = np.linalg.norm(b - A_host @ x) / np.linalg.norm(b)
    x_ref = spla.spsolve(A_host.tocsc(), b)
    err = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
    report["ex1"].update(host_rel_res=host_rel, rel_err_vs_scipy=err)
    print(f"ex1: {e.iters} iterations, rel res {e.rel_res_norm:.3e} "
          f"(host {host_rel:.3e}), |x - x_scipy|/|x_scipy| {err:.3e}, "
          f"setup {e.setup_time:.4f} s, solve {e.solve_time:.4f} s")
    check(host_rel <= 1e-6 and err <= 1e-4,
          f"ex1: host check failed (rel res {host_rel:.3e}, err {err:.3e})")


def run_laplacian(nx, dtype):
    """PCG + AMG to 1e-8 on an nx³ Laplacian through the driver API."""
    import numpy as np
    from hypredrive_tpu_torch import HypreDrive

    drv = HypreDrive()
    drv.set_library_mode()
    drv.input_args_from_dict({
        "general": {"dtype": dtype},
        "linear_system": {"generate": {"kind": "laplacian_7pt", "nx": nx},
                          "rhs_mode": "ones"},
        "solver": {"pcg": {"relative_tol": 1e-8, "max_iter": 100}},
        "preconditioner": "amg",
    })
    sys_ = drv.linear_system_build()
    drv.precon_create()
    drv.linear_solver_create()
    drv.linear_solver_setup()
    res = drv.linear_solver_apply()
    e = drv.stats.entries[-1]
    x = drv.get_solution()
    levels = len(drv.precon.state.levels)
    out = {"rows": sys_.num_rows, "nnz": sys_.nnz, "levels": levels,
           "level_rows": [lv.A.shape[0] for lv in drv.precon.state.levels],
           "iters": res.iters, "rel_res_norm": res.rel_res_norm,
           "converged": res.converged, "build_s": e.build_time,
           "setup_s": e.setup_time, "solve_s": e.solve_time,
           "history": [float(h) for h in res.res_history[:res.iters + 1]]}
    check(x.shape == (sys_.num_rows,) and np.all(np.isfinite(x)),
          f"{nx}^3: solution not finite or of the wrong shape")
    print(f"{nx}^3 {dtype}: {sys_.num_rows} rows, {sys_.nnz} nnz, "
          f"{levels} levels, {res.iters} iterations, rel res "
          f"{res.rel_res_norm:.3e}, build {e.build_time:.3f} s, setup "
          f"{e.setup_time:.3f} s, solve {e.solve_time:.4f} s")
    # a second solve on the same hierarchy: the first one also pays the
    # caching allocator's first allocations at these sizes
    drv.reset_initial_guess()
    out["solve_warm_s"] = drv.linear_solver_apply().solve_time
    print(f"  second solve: {out['solve_warm_s']:.4f} s")
    out["profile"] = profile_solve(drv)
    drv.destroy()
    return out


def profile_solve(drv):
    """One more solve on the set-up hierarchy under torch.profiler: wall
    time, device busy time (sum of kernel times) and the top kernels.
    Informational only: a profiler that records nothing fails no phase."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    drv.reset_initial_guess()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drv.linear_solver_apply()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events, less the record_function spans mirrored there
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith(("hypredrv::", "amg_L"))]
    busy = sum(dev_us(e) for e in kern) / 1e6
    top = [{"name": e.key[:80], "ms": dev_us(e) / 1e3, "count": e.count}
           for e in sorted(kern, key=dev_us, reverse=True)[:8]]
    print(f"  profiled solve: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%)")
    for t in top:
        print(f"    {t['ms']:9.3f} ms  x{t['count']:5d}  {t['name']}")
    return {"wall_s": wall, "device_busy_s": busy, "top": top}


def phase_64(report):
    r = report["lap64_f32"] = run_laplacian(64, "float32")
    # the recurrence reaches 1e-8; the true float32 residual stops near
    # eps32·κ(A) ≈ 6e-8 · 1.7e3 ≈ 1e-4 for this operator
    check(r["converged"] and r["rel_res_norm"] <= 1e-3,
          f"64^3: not converged (true rel {r['rel_res_norm']:.3e})")
    check(abs(r["iters"] - JAX_ITERS_64_F32) <= 1,
          f"64^3: {r['iters']} iterations, expected {JAX_ITERS_64_F32}±1")
    check(r["levels"] == JAX_LEVELS_64,
          f"64^3: {r['levels']} levels, expected {JAX_LEVELS_64}")


def phase_128(report):
    r = report["lap128_f64"] = run_laplacian(128, "float64")
    check(r["rows"] == 2097152 and r["nnz"] == 14581760,
          f"128^3: {r['rows']} rows / {r['nnz']} nnz")
    check(r["converged"] and r["rel_res_norm"] <= 1e-8,
          f"128^3: not converged (rel {r['rel_res_norm']:.3e})")
    check(abs(r["iters"] - JAX_ITERS_128_F64) <= 1,
          f"128^3: {r['iters']} iterations, JAX package "
          f"{JAX_ITERS_128_F64}±1")
    # same recurrence, other summation orders: float64 rounding, amplified
    # over a dozen iterations, stays far below 1e-6
    k = min(len(r["history"]), len(JAX_HISTORY_128_F64))
    dev = max(abs(a / b - 1) for a, b in zip(r["history"][:k],
                                              JAX_HISTORY_128_F64[:k]))
    r["history_rel_dev_vs_jax"] = dev
    print(f"128^3 residual history vs the JAX package: max rel dev {dev:.3e}")
    check(dev <= 1e-6, f"128^3: history deviates from JAX by {dev:.3e}")


KERNELS = {
    "dia_spmv": ("hypredrive_tpu_torch/csrc/dia_spmv.cu",
                 "hypredrive_tpu/ops/pallas_dia.py:99 (K1); "
                 "hypredrive_tpu/ops/pallas_dia.py:171 (K2)"),
    "csr_spmv": ("hypredrive_tpu_torch/csrc/csr_spmv.cu",
                 "hypredrive_tpu/ops/pallas_spmv.py:85 (K3); "
                 "hypredrive_tpu/ops/pallas_spmv.py:216 (K4)"),
}


def main() -> int:
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from hypredrive_tpu_torch.ops.csr_spmv import csr_spmv
    from hypredrive_tpu_torch.ops.dia_spmv import dia_spmv

    report = {}
    failures = []
    t_start = time.perf_counter()

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn(report)
        except Exception as exc:  # record every phase's failure, go on
            failures.append(f"{name}: {type(exc).__name__}: {exc}")
            print(f"PHASE {name} FAILED: {exc}", file=sys.stderr)
        report.setdefault("phase_s", {})[name] = time.perf_counter() - t0

    run("env", phase_env)
    if not failures:
        run("kernels", phase_kernels)
        dia_spmv.launches = 0
        csr_spmv.launches = 0
        run("ex1", phase_ex1)
        run("lap64", phase_64)
        run("lap128", phase_128)
        launches = {"dia_spmv": dia_spmv.launches,
                    "csr_spmv": csr_spmv.launches}
        report["launches"] = launches
        print(f"main-path kernel launches: {launches}")
        for name, n in launches.items():
            if n <= 0:
                failures.append(f"launches: {name} never launched")
    report["total_s"] = time.perf_counter() - t_start
    report["failures"] = failures
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1

    table = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in report["kernel_checks"] if r["kernel"] == name]
        main_row = next(r for r in rows if r["dtype"] == "float64")
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": report["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "shape": f"{main_row['shape']} {main_row['dtype']}",
        })
    print(json.dumps({"kernels": table}))
    print(report["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
