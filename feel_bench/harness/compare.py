"""The comparison that decides ``correct`` for a training entry, in two
stages: the program's first three steps against the reference's from the
seed, and its steps m + 1 and m + 2 (the L-BFGS ring full, wrapped by the
first and read across the wrap by the second) against the reference's from
the program's own state before them.

Numbers compared (each with a limit of its own, ``limits/<cell>.json``):

* ``loss_gap``: the largest relative gap of a step's loss, over the five;
* ``step1_gap``, ``fisher1_gap``: by the worst leaf, the gap between the
  program's and the reference's norm of the first step (the first gradient
  as the optimizer took it, -lr * clip * g) and of the first Fisher
  diagonal, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
* ``change_gap``: the same for each leaf's change over the first three
  steps, leaving out leaves whose first step in the reference is under a
  thousandth of the median leaf's (nought to rounding: they move by
  round-off alone);
* ``wrap_gap``: the same, worst over each leaf's change over steps m + 1
  and m + 2 and over each live pair's s and y after them, pair by pair
  from the newest (the program's read by its ring index): a pair written
  to the wrong slot, or an oldest pair kept, puts one pair where another
  should be.
"""
from __future__ import annotations

import math
import statistics

NAMES = ("loss_gap", "step1_gap", "fisher1_gap", "change_gap", "wrap_gap")


def _worst_leaf(prog: list, ref: list, keep=None) -> float:
    med = statistics.median(ref)
    idx = range(len(ref)) if keep is None else keep
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-300) for i in idx)


def _ring_gap(prog: list, ref: list) -> float:
    """Pair by pair from the newest; a pair one side lacks reads as
    zeros."""
    width = len((prog or ref)[0]) if (prog or ref) else 0
    pad = lambda ages, n: ages + [[0.0] * width] * (n - len(ages))  # noqa: E731
    n = max(len(prog), len(ref))
    return max((_worst_leaf(p, r) for p, r in zip(pad(prog, n), pad(ref, n), strict=True)
                if max(r) > 0), default=1.0 if n else 0.0)


def numbers(prog: dict, ref: dict) -> dict:
    losses = list(zip(prog["loss"], ref["loss"], strict=True))
    losses += list(zip(prog["wrap"]["loss"], ref["wrap"]["loss"], strict=True))
    med = statistics.median(ref["step1"])
    keep = [i for i, v in enumerate(ref["step1"]) if v >= 1e-3 * med]
    pw, rw = prog["wrap"], ref["wrap"]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in losses),
            "step1_gap": _worst_leaf(prog["step1"], ref["step1"]),
            "fisher1_gap": _worst_leaf(prog["fisher1"], ref["fisher1"]),
            "change_gap": _worst_leaf(prog["change"], ref["change"], keep),
            "wrap_gap": max(_worst_leaf(pw["change"], rw["change"]),
                            _ring_gap(pw["s"], rw["s"]), _ring_gap(pw["y"], rw["y"]))}


def judge(nums: dict, limits: dict) -> bool:
    """Every compared number finite and at or under its limit; a limit of
    None marks a number that is read and printed but not compared (it has
    no upper reading: PERF.md gives its readings)."""
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in NAMES if limits[k] is not None)
