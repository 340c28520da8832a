"""The harness's own tests (run from the repository root:
``python -m pytest -q feel_bench/tests``).  ``smoke_root`` is a copy of the
manifest and data files with every configuration and traffic mix cut to a
size the CPU runs in seconds; the code stays where it is."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_CONFIGS = {
    "granite-8b-2L.json": {"hidden_size": 64, "num_attention_heads": 4,
                           "num_key_value_heads": 2, "head_dim": 16,
                           "intermediate_size": 128, "vocab_size": 256,
                           "torch_dtype": "float32"},
}
SMOKE_TRAFFIC = {
    "train_s4096": {"seq_len": 64, "pool": 2, "profile_units": 1},
    "train_s512": {"seq_len": 32, "pool": 2, "profile_units": 1},
}


def _update(path: Path, changes: dict) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("smoke")
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(BENCH / sub, root / BENCH.name / sub)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, changes in SMOKE_CONFIGS.items():
        _update(root / BENCH.name / "configs" / name, changes)
    for name, changes in SMOKE_TRAFFIC.items():
        _update(root / BENCH.name / "traffic" / f"{name}.json", changes)
    return root


@pytest.fixture(scope="session")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
