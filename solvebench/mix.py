"""The one traffic generator.  A mix is a data file of parameters
(``traffic/<mix>.json``); this module checks it against what the harness
drives and makes the right-hand sides it asks for.  A key or a value the
harness does not drive is refused, so that a new mix never runs another
mix's traffic unannounced.

Driven today:

- ``loop``: ``closed`` — the next solve starts when the last has ended;
- ``callers``: 1;
- ``rhs``: ``standard_normal`` — ``rhs_count`` vectors drawn from the seed
  in set-up, taken in turn;
- ``x0``: ``zero`` — each solve starts from x0 = 0;
- ``solution_to_host``: true — each solve ends with x on the host;
- ``check_sample``: how many of the window's solves the reference checks;
- ``why``: free text.
"""

from __future__ import annotations

import numpy as np

FIXED = {"loop": "closed", "callers": 1, "rhs": "standard_normal",
         "x0": "zero", "solution_to_host": True}
COUNTS = ("rhs_count", "check_sample")


def check(mix: dict) -> dict:
    """The mix, if the harness drives every key of it; ValueError naming
    the first key it does not."""
    for key, value in mix.items():
        if key in FIXED:
            if value != FIXED[key] or type(value) is not type(FIXED[key]):
                raise ValueError(f"traffic {key}={value!r} is not driven "
                                 f"(only {FIXED[key]!r})")
        elif key in COUNTS:
            if type(value) is not int or value < 1:
                raise ValueError(f"traffic {key}={value!r}: a whole "
                                 "number of at least 1")
        elif key != "why":
            raise ValueError(f"traffic key {key!r} is not driven")
    missing = [k for k in (*FIXED, *COUNTS) if k not in mix]
    if missing:
        raise ValueError(f"traffic lacks {missing}")
    return mix


def seed_rng(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed, negative or past 64 bits."""
    return np.random.default_rng(seed % (1 << 64))


def right_hand_sides(mix: dict, n: int, seed: int) -> np.ndarray:
    """The mix's ``rhs_count`` right-hand sides of length n, float64,
    from the seed."""
    return seed_rng(seed).standard_normal((mix["rhs_count"], n))
