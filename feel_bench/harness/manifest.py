"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cell, its configuration and its traffic; each is a file of
its own under ``feel_bench/`` (``configs/``, ``traffic/``, ``limits/``,
``entries/``, ``metrics/``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads(
            (root / configs[self.workload["config"]]["file"]).read_text())
        here = root / BENCH.name
        self.traffic = json.loads(
            (here / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((here / "limits" / f"{name}.json").read_text())
        self.end_to_end = [m for m in manifest["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def entry_class(self):
        return importlib.import_module(f"entries.{self.traffic['entry']}").Entry


def reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (names hold dots, so the
    file is loaded by its path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"feel_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
