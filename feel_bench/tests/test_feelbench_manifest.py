"""``BENCHMARK.json`` against the benchmark's contract, and every piece a
cell names found by name under ``feel_bench/``."""
from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes(manifest):
    assert set(manifest) == KEYS
    assert len(json.dumps(manifest).encode()) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"])


def test_configs(manifest):
    cfgs = manifest["configs"]
    assert 1 <= len(cfgs) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in cfgs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not (key.endswith(("_dim", "_rank", "_size", "_expand"))
                        or key in ("num_experts_per_tok", "expansion_factor")), key


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def _reports(metric, cell) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics(manifest):
    e2e, layer = manifest["end_to_end"], manifest["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
        mover = next(e for e in e2e if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert _reports(mover, cell), (m["name"], cell)
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        got = [m["name"] for m in e2e if _reports(m, cell)]
        assert "setup_s" in got and len(got) >= 2, cell
        assert any(_reports(m, cell) for m in layer), cell


def test_every_piece_is_found_by_name(manifest):
    from harness import compare
    from harness import manifest as mf

    for w in manifest["workloads"]:
        cell = mf.Cell(manifest, w["name"], ROOT)
        assert hasattr(cell.entry_class(), "setup")
        assert set(cell.limits) == set(compare.NAMES)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(mf.reader(m["name"]))
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "metrics"])
def test_no_orphan_files(manifest, kind):
    """Every data file and reader belongs to some entry of the manifest."""
    names = {"configs": {c["file"].rsplit("/", 1)[1] for c in manifest["configs"]},
             "traffic": {w["traffic"] + ".json" for w in manifest["workloads"]},
             "limits": {w["name"] + ".json" for w in manifest["workloads"]},
             "metrics": {m["name"] + ".py" for m in
                         manifest["end_to_end"] + manifest["per_layer"]}}[kind]
    assert {p.name for p in (BENCH / kind).iterdir() if p.suffix in (".json", ".py")} == names


def test_config_knobs_are_the_programs():
    """The configuration files state what the program runs: the LLM
    optimizer's knobs are ``opt_config``'s."""
    from repro_torch.configs.base import get
    from repro_torch.launch.train import opt_config

    g = json.loads((BENCH / "configs" / "granite-8b-2L.json").read_text())
    arch = get(g["arch"])
    for key, ours in (("hidden_size", arch.d_model), ("num_attention_heads", arch.num_heads),
                      ("num_key_value_heads", arch.num_kv_heads),
                      ("head_dim", arch.head_dim), ("intermediate_size", arch.d_ff),
                      ("vocab_size", arch.vocab_size), ("rope_theta", arch.rope_theta),
                      ("torch_dtype", arch.dtype)):
        assert g[key] == ours, key
    oc = opt_config(arch, learning_rate=g["optimizer"]["learning_rate"])
    opt = g["optimizer"]
    assert (oc.m, oc.damping, oc.rel_damping, oc.fim_ema, oc.max_step_norm) == (
        opt["lbfgs_m"], opt["fim_damping"], opt["rel_damping"], opt["fim_ema"],
        opt["max_step_norm"])
    assert str(oc.history_dtype) == "torch." + opt["history_dtype"]
