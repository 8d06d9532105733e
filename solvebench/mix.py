"""The one traffic generator.  A mix is a data file of parameters
(``traffic/<mix>.json``); this module checks it against what the harness
drives and makes the right-hand sides it asks for.  A key or a value the
harness does not drive is refused, so that a new mix never runs another
mix's traffic unannounced.

Driven today, in every mix:

- ``loop``: ``closed`` — the next solve starts when the last has ended;
- ``callers``: 1;
- ``x0``: ``zero`` — each solve starts from x0 = 0;
- ``solution_to_host``: true — each solve ends with x on the host;
- ``check_sample``: how many of the window's solves the reference checks;
- ``why``: free text;

and one of two shapes, chosen by ``rhs``:

- ``rhs``: ``standard_normal`` — one system, set up once; ``rhs_count``
  vectors drawn from the seed in set-up, taken in turn;
- ``rhs``: ``drift`` with ``matrix``: ``new_each_solve`` — a Newton
  sequence: solve k takes system k of the configuration's sequence (its
  problem kind's ``sequence()``), ``systems_count`` systems made in
  set-up and never repeated in a run, ``newton_per_timestep`` of them to
  a time step of the library's timestep schedule; b_k = cos(0.3 k)·1 +
  0.1·N(0, 1), the noise drawn from the seed in order.
"""

from __future__ import annotations

import numpy as np

FIXED = {"loop": "closed", "callers": 1, "rhs": "standard_normal",
         "x0": "zero", "solution_to_host": True}
COUNTS = ("rhs_count", "check_sample")
# the Newton sequence: FIXED with these values in place, and its counts
SEQUENCE_FIXED = dict(FIXED, rhs="drift", matrix="new_each_solve")
SEQUENCE_COUNTS = ("systems_count", "newton_per_timestep", "check_sample")


def is_sequence(mix: dict) -> bool:
    """Whether the mix brings a new system on every solve."""
    return mix.get("rhs") == SEQUENCE_FIXED["rhs"]


def check(mix: dict) -> dict:
    """The mix, if the harness drives every key of it; ValueError naming
    the first key it does not."""
    fixed, counts = ((SEQUENCE_FIXED, SEQUENCE_COUNTS) if is_sequence(mix)
                     else (FIXED, COUNTS))
    for key, value in mix.items():
        if key in fixed:
            if value != fixed[key] or type(value) is not type(fixed[key]):
                raise ValueError(f"traffic {key}={value!r} is not driven "
                                 f"(only {fixed[key]!r})")
        elif key in counts:
            if type(value) is not int or value < 1:
                raise ValueError(f"traffic {key}={value!r}: a whole "
                                 "number of at least 1")
        elif key != "why":
            raise ValueError(f"traffic key {key!r} is not driven")
    missing = [k for k in (*fixed, *counts) if k not in mix]
    if missing:
        raise ValueError(f"traffic lacks {missing}")
    if is_sequence(mix) and mix["systems_count"] % \
            mix["newton_per_timestep"]:
        raise ValueError(f"traffic systems_count={mix['systems_count']} "
                         "is not whole time steps of newton_per_timestep="
                         f"{mix['newton_per_timestep']}")
    return mix


def seed_rng(seed: int) -> np.random.Generator:
    """A generator for any whole-number seed, negative or past 64 bits."""
    return np.random.default_rng(seed % (1 << 64))


def right_hand_sides(mix: dict, n: int, seed: int) -> np.ndarray:
    """The mix's ``rhs_count`` right-hand sides of length n, float64,
    from the seed."""
    return seed_rng(seed).standard_normal((mix["rhs_count"], n))


def drift_right_hand_sides(mix: dict, n: int, seed: int) -> np.ndarray:
    """b_0 … b_{systems_count−1} of length n, float64: b_k = cos(0.3 k)·1
    + 0.1·N(0, 1), the noise drawn from the seed in order."""
    rng = seed_rng(seed)
    return np.stack([np.cos(0.3 * k) * np.ones(n)
                     + 0.1 * rng.standard_normal(n)
                     for k in range(mix["systems_count"])])
