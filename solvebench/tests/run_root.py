"""Run a cell of a manifest root of the tests' own, as the tests do:

    python3 -m solvebench.tests.run_root --root <dir> [--no-card] \
        --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--no-card`` skips the harness's look for a card and runs on the CPU.
"""

import sys

from solvebench.run import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    i = argv.index("--root")
    root = argv[i + 1]
    del argv[i:i + 2]
    card = "--no-card" not in argv
    if not card:
        argv.remove("--no-card")
    sys.exit(main(argv, root=root, require_card=card))
