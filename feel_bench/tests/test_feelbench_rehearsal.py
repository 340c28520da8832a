"""Every cell driven end to end on the CPU at a smoke size (the harness's
look for a card skipped): set-up, the window or the traced run, the
comparison with the reference, the result line.  The control flow only;
no number from here is a device number."""
from __future__ import annotations

import io
import json
import time

import pytest
import torch

from harness import compare, runner

CELLS = ["granite_train.s4096", "granite_train.s512"]


def run(smoke_root, cell, trace, seed=2**31 + 11):
    out, err = io.StringIO(), io.StringIO()
    result = runner.run_cell(cell, seed, 0.5, trace, torch.device("cpu"),
                             time.perf_counter(), root=smoke_root, out=out, err=err)
    assert json.loads(out.getvalue().splitlines()[-1]) == json.loads(json.dumps(result))
    return result, err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run(smoke_root, cell):
    result, err = run(smoke_root, cell, False)
    assert result["correct"], err
    assert list(result)[-1] == "checks"
    manifest = json.loads((smoke_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in manifest["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    # no memory counter on the CPU
    assert set(result["metrics"]) == want - {"peak_mem_gb"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert err.splitlines()[-1].startswith(f"check {compare.NAMES[-1]} ")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(smoke_root, cell):
    result, err = run(smoke_root, cell, True)
    assert result["correct"], err
    spans = {"granite_train.s4096": {"server_ms.train", "model_ms.train", "mfu.train"},
             "granite_train.s512": {"server_ms.train_short", "model_ms.train_short",
                                    "mfu.train_short"}}
    # the device-trace readers find nothing to read on the CPU
    assert set(result["metrics"]) == spans[cell]
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(smoke_root):
    from harness import manifest

    cell = manifest.Cell(manifest.load(smoke_root), "granite_train.s512", smoke_root)
    entry = cell.entry_class()(cell.config, cell.traffic, 2**33 + 5, torch.device("cpu"))
    assert torch.equal(entry.batch(4), entry.batch(4))
    assert not torch.equal(entry.batch(4), entry.batch(5))
