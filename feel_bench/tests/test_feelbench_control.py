"""The control: the plain reference put in the program's place and
computed one precision below the configuration's (fp8 for granite's
bfloat16) fails the cell's comparison.

Held at a smoke size on the CPU; the cell-size readings are
``calibrate.py``'s on the card (PERF.md)."""
from __future__ import annotations

import pytest
import torch

from harness import compare, manifest


def _entry(root, cell, seed, device):
    c = manifest.Cell(manifest.load(root), cell, root)
    e = c.entry_class()(c.config, c.traffic, seed, device)
    e.setup()
    e.follow()
    e.release()
    return c, e


@pytest.mark.parametrize("cell", ["granite_train.s512", "granite_train.s4096"])
def test_fp8_control_fails(smoke_root, cell):
    c, e = _entry(smoke_root, cell, 2**31 + 3, torch.device("cpu"))
    wrap, wrap8 = e.reference_wrap(), e.reference_wrap(precision="fp8")
    e.drop_snapshot()
    ref = {**e.reference_seed(), "wrap": wrap}
    control = {**e.reference_seed(precision="fp8"), "wrap": wrap8}
    assert compare.judge(compare.numbers(e.readings, ref), c.limits)
    assert not compare.judge(compare.numbers(control, ref), c.limits)



def test_limits_follow_the_rule():
    """``calibrate.py --limits``: the lower reading is the program's largest;
    the control counts from 3 x the lower, a fault from 10 x, the unchanged
    state's 1 from 3 x; the limit lies between, nearer the upper; a number
    with no upper reading is not compared."""
    import calibrate

    rows = [{"side": "program", "numbers": {"a": 0.001, "b": 0.01}},
            {"side": "program", "numbers": {"a": 0.002, "b": 0.02}},
            {"side": "control", "numbers": {"a": 0.004, "b": 0.03}},
            {"side": "half_batch", "numbers": {"a": 0.05, "b": 0.1}},
            {"side": "ring", "numbers": {"a": 0.003, "b": 0.001}}]
    limits, basis = calibrate.limits_from(rows, ("a", "b"))
    assert basis["a"]["lower"] == 0.002 and basis["a"]["upper"] == 0.05
    assert basis["a"]["upper_from"] == "half_batch"
    assert 0.002 * 3 < limits["a"] < 0.05 and limits["a"] == 0.017
    assert limits["b"] is None and basis["b"]["upper"] is None
