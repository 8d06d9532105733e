"""Command-line driver.

Counterpart of ``hypredrive_tpu/cli.py``: ``python -m hypredrive_tpu_torch.cli
[options] input.yml ...`` (ref: src/internal/main.c:15-34 usage, :175
RunSolveLoops, :269 main).

Options:
  -h/--help [topic]   schema-generated help topics
  -i/--info           system information report
  -a PATH VALUE       config override (repeatable), path like sect:sub:key
  -p/--prec-preset P  preconditioner preset
  -n/--dry-run        parse + echo config only
  --profile DIR       write a torch.profiler trace of the run into DIR

Multiple YAML files run as sequential cases (ref: main.c:308-331).
``-a general:exec_policy host`` runs on the CPU; the default is CUDA.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Tuple

from .config.help import help_text
from .core.errors import HypredrvError
from .core.info import library_banner, system_info


def _print_banner():
    import torch

    print(f"Date and time: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
    print(f"Using {library_banner()}\n")
    if torch.cuda.is_available():
        print(f"Running on {torch.cuda.device_count()} device(s) "
              f"[{torch.cuda.get_device_name(0)}]")
    else:
        print("Running on 0 CUDA device(s)")


def parse_argv(argv: List[str]):
    """Parse CLI arguments (the reference grammar: ``-a path value`` pairs
    appear after or before the YAML filename)."""
    configs: List[str] = []
    overrides: List[Tuple[str, str]] = []
    preset: Optional[str] = None
    want_help: Optional[str] = None
    want_info = False
    dry_run = False
    profile_dir: Optional[str] = None

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("-h", "--help"):
            want_help = ""
            if i + 1 < len(argv) and not argv[i + 1].startswith("-") \
                    and not argv[i + 1].endswith((".yml", ".yaml")):
                want_help = argv[i + 1]
                i += 1
        elif arg in ("-i", "--info"):
            want_info = True
        elif arg in ("-a", "--args"):
            if i + 2 >= len(argv):
                raise SystemExit("-a requires PATH VALUE")
            overrides.append((argv[i + 1], argv[i + 2]))
            i += 2
        elif arg in ("-p", "--prec-preset"):
            if i + 1 >= len(argv):
                raise SystemExit("-p requires PRESET")
            preset = argv[i + 1]
            i += 1
        elif arg in ("-n", "--dry-run"):
            dry_run = True
        elif arg == "--profile":
            if i + 1 >= len(argv):
                raise SystemExit("--profile requires DIR")
            profile_dir = argv[i + 1]
            i += 1
        elif arg.startswith("-"):
            raise SystemExit(f"unknown option {arg}")
        else:
            configs.append(arg)
        i += 1
    return (configs, overrides, preset, want_help, want_info, dry_run,
            profile_dir)


def run_one_config(path: str, overrides=None, preset=None, dry_run=False,
                   collect=None) -> int:
    """ref: RunOneConfig (main.c:231).

    ``collect``: optional list; the driver object is appended so callers
    can inspect ``drv.stats`` entries (they survive destroy)."""
    from .api import HypreDrive

    drv = HypreDrive()
    if collect is not None:
        collect.append(drv)
    try:
        args = drv.input_args_parse(path, overrides, preset)
        if args.general.print_config_params:
            # echo the effective config between bars (ref: args.c:1568)
            from .config.yamlparse import echo_tree

            bar = "-" * 84
            print(bar)
            print(echo_tree(args.raw_tree))
            print(bar)
        if dry_run:
            return 0

        ls = args.linear_system
        num_systems = max(1, ls.num_systems)
        if ls.init_suffix >= 0 and ls.last_suffix >= 0:
            num_systems = ls.last_suffix - ls.init_suffix + 1
        if ls.sequence_filename:
            from .io.lsseq import read_summary

            num_systems = read_summary(ls.sequence_filename).num_systems

        # Solve loops: systems × precon variants × repetitions
        # (ref: RunSolveLoops, main.c:175-229).
        for _ in range(num_systems):
            system = drv.linear_system_build()
            bar = "=" * 84
            print(bar)
            print(f"Solving linear system #{drv.current_system_index} with "
                  f"{system.num_rows} rows and {system.nnz} nonzeros...")
            print(bar)
            if ls.eigspec.enable:
                from .linsys.eigspec import compute_eigenspectrum

                eig_precon = None
                if ls.eigspec.preconditioned:
                    # the spectrum of M⁻¹A needs a set-up preconditioner
                    # (ref: eigspec.c precon-apply callback)
                    drv.precon_create()
                    drv.precon.setup(system)
                    eig_precon = drv.precon
                compute_eigenspectrum(system, ls.eigspec, precon=eig_precon)
                if eig_precon is not None:
                    drv.precon_destroy()
            for v in range(args.num_precon_variants):
                if args.num_precon_variants > 1:
                    drv.set_precon_variant(v)
                reps = max(1, args.general.num_repetitions)
                warmups = 1 if args.general.warmup else 0
                for rep in range(warmups + reps):
                    is_warmup = rep < warmups
                    if not is_warmup:
                        drv.annotate_begin("Run", rep - warmups)
                    drv.reset_initial_guess()
                    drv.precon_create()
                    drv.linear_solver_create()
                    drv.linear_solver_setup()
                    drv.linear_solver_apply()
                    drv.precon_destroy()
                    drv.linear_solver_destroy()
                    if not is_warmup:
                        drv.annotate_end("Run", rep - warmups)
        if args.general.statistics:
            drv.stats_print()
        return 0
    finally:
        drv.destroy()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        (configs, overrides, preset, want_help, want_info, dry_run,
         profile_dir) = parse_argv(argv)
    except SystemExit as exc:
        print(exc, file=sys.stderr)
        return 2

    if want_help is not None:
        print(help_text(want_help or None))
        return 0
    if want_info:
        print(system_info())
        if not configs:
            return 0
    if not configs:
        print("usage: python -m hypredrive_tpu_torch.cli [-h [topic]] [-i] "
              "[-a PATH VALUE]... [-p PRESET] [-n] [--profile DIR] "
              "input.yml ...", file=sys.stderr)
        return 2

    _print_banner()
    prof = None
    if profile_dir:
        # a trace of the whole run (the Caliper-report analogue, ref:
        # include/internal/stats.h:47-80): the hypredrv::* spans of
        # core/trace.py (the stats phases, the host set-up, the device
        # loop's launches and flag waits) name the host work around the
        # device's operations; open it in Perfetto or TensorBoard
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(profile_dir))
        prof.start()
    status = 0
    try:
        for path in configs:
            try:
                status |= run_one_config(path, list(overrides), preset,
                                         dry_run)
            except HypredrvError as exc:
                print(f"ERROR: {exc}", file=sys.stderr)
                status = 1
    finally:
        if prof is not None:
            prof.stop()
    print(f"\nDate and time: {time.strftime('%Y-%m-%d %H:%M:%S')}")
    print("hypredrive-tpu-torch done!")
    return status


if __name__ == "__main__":
    sys.exit(main())
