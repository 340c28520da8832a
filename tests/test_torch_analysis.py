"""repro_torch.analysis held against repro.analysis, then its torch rules.

Parity: each case of the reference's own suite (tests/test_analysis.py)
for RPL001, RPL004, RPL005, RPL006, the pragmas, the baseline and the
CLI runs through both linters, ``src/repro/`` mapped to
``src/repro_torch/`` and ``repro.`` imports to ``repro_torch.``, and must
give the same (rule, line, col) findings.  The torch-idiom cases (RPL001's
torch draws, RPL002's default-dtype/TF32 flips and fleet dtypes, RPL003's
device bodies) have no JAX twin: each rule has a case that fires, one
that stays quiet and one outside its scope.  Everything runs on
in-memory sources, apart from the CLI's temporary files and three
subprocesses.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

import repro.analysis.rules  # noqa: F401  (registers the reference rules)
import repro_torch.analysis.rules  # noqa: F401  (registers the port's rules)
from repro.analysis import core as ref_core
from repro.analysis.cli import main as ref_cli
from repro_torch.analysis import core as port_core
from repro_torch.analysis.cli import main as port_cli

ROOT = Path(__file__).resolve().parents[1]
SIM_PATH = "src/repro/edge/some_module.py"

REF = SimpleNamespace(core=ref_core, cli=ref_cli, path=lambda p: p,
                      src=lambda s: s)
PORT = SimpleNamespace(
    core=port_core, cli=port_cli,
    path=lambda p: p.replace("src/repro/", "src/repro_torch/"),
    src=lambda s: re.sub(r"\brepro\.", "repro_torch.", s))


def lint_with(linter, src: str, path: str = SIM_PATH, rule=None) -> list:
    mod = linter.core.ModuleSource(linter.path(path),
                                   linter.src(textwrap.dedent(src)))
    rules = [linter.core.get(rule)()] if rule else None
    return linter.core.check_module(mod, rules=rules)


def port_lint(src: str, path: str, rule=None) -> list:
    """The port's findings as (rule, line) pairs."""
    mod = port_core.ModuleSource(path, textwrap.dedent(src))
    rules = [port_core.get(rule)()] if rule else None
    return [(f.rule, f.line) for f in port_core.check_module(mod, rules=rules)]


def where(findings) -> list:
    return [(f.rule, f.line, f.col) for f in findings]


# ---------------------------------------------------------------------------
# parity: the reference suite's cases, through both linters
# ---------------------------------------------------------------------------
RPL001_BAD = """\
    import time
    import numpy as np

    def sample():
        t = time.time()
        noise = np.random.randn(4)
        return t, noise
"""
RPL001_GOOD = """\
    import numpy as np

    def sample(clock, rng: np.random.Generator):
        t = clock.now
        noise = rng.standard_normal(4)
        gen = np.random.default_rng(17)
        return t, noise, gen
"""
RPL001_DATETIME = """\
    import random
    from datetime import datetime

    def stamp():
        return datetime.now(), random.random()
"""
RPL004_STRATEGY_BAD = """\
    from repro.fed.strategies.base import FedStrategy, RoundPlan, register

    @register("broken")
    class Broken(FedStrategy):
        def client_step(self, data, rng, context=None):
            return None, 0.0
"""
RPL004_PLAN_INCOMPLETE = """\
    from repro.fed.strategies.base import (FedStrategy, PhasePlan, RoundPlan,
                                           register)

    @register("half")
    class Half(FedStrategy):
        def _make_plan(self):
            return RoundPlan(phases=(PhasePlan("up", up_floats=10.0),))
"""
RPL004_STRATEGY_GOOD = """\
    from repro.fed.strategies.base import (FedStrategy, PhasePlan, RoundPlan,
                                           register)

    @register("ok")
    class Ok(FedStrategy):
        def _make_plan(self):
            return RoundPlan(phases=(PhasePlan("up", up_floats=10.0),),
                             flops=lambda n_k: 6.0 * n_k, summable=True)
"""
RPL004_IMPORTED_BASE = """\
    from repro.fed.strategies.base import register
    from repro.fed.strategies.fedavg import LocalSolveStrategy

    @register("prox")
    class Prox(LocalSolveStrategy):
        pass
"""
RPL004_CODEC_BAD = """\
    from repro.fed.codecs import PayloadCodec, register

    class Fp16(PayloadCodec):
        pass

    register("fp16", Fp16)
"""
RPL004_CODEC_GOOD = """\
    from repro.fed.codecs import PayloadCodec, register

    class Fp16(PayloadCodec):
        def wire_bytes(self, n_floats):
            return 2.0 * n_floats

    register("fp16", Fp16)
"""
RPL004_VEC_BAD = """\
    class P:
        def decide_vectorized(self, fstate, extra):
            return None
"""
RPL004_VEC_GOOD = """\
    class P:
        def decide_vectorized(self, fstate):
            return None
"""
RPL005_BAD = """\
    def round_end(tracer, t, cohort):
        tracer.event("alloc", "client", t, detail=f"cohort={cohort}")
        tracer.metrics.counter("drops_total").inc(1.0, **{"reason": "x"})
"""
RPL005_GOOD = """\
    def round_end(tracer, t, cohort):
        if tracer.enabled:
            tracer.event("alloc", "client", t, detail=f"cohort={cohort}")
        tracer.event("alloc", "client", t, cohort=cohort)  # lazy: no work
"""
RPL005_EARLY_OUT = """\
    def trace_round(tracer, rows):
        if not tracer.enabled:
            return
        tracer.record_round({"rows": len(rows)})
"""
RPL005_ALIAS = """\
    def meter(self, x):
        m = self.tracer.metrics
        m.gauge("battery_j").set(x, labels={"client": 1})
"""
RPL005_OTHER_RECEIVERS = """\
    def collect(seen, items):
        seen.add({"k": 1})
        items.set(0, {"k": 1})
"""
RPL006_BAD = """\
    def meter(ledger, plan, k):
        ledger.upload(plan.up_floats, k, aggregatable=True)
"""
RPL006_GOOD = """\
    def meter(ledger, ph, k, billed):
        ledger.upload(ph.up_floats, k, aggregatable=True,
                      wire_bytes=ph.wire_up_bytes())
        ledger.upload_per_client(billed, aggregatable=True)
"""


def _pragma(comment: str, above: bool = False) -> str:
    call = "return time.time()"
    body = (f"    # {comment}\n    {call}\n" if above
            else f"    {call}  # {comment}\n")
    return "import time\n\ndef stamp():\n" + body


# the reference suite's lint cases: (source, path, rule or None for every
# rule)
LINT_CASES = {
    "rpl001_bad": (RPL001_BAD, SIM_PATH, "RPL001"),
    "rpl001_good": (RPL001_GOOD, SIM_PATH, "RPL001"),
    "rpl001_out_of_scope": (RPL001_BAD, "benchmarks/common.py", None),
    "rpl001_fed": (RPL001_BAD, "src/repro/fed/x.py", None),
    "rpl001_obs": (RPL001_BAD, "src/repro/obs/x.py", None),
    "rpl001_datetime_random": (RPL001_DATETIME, SIM_PATH, "RPL001"),
    "rpl001_seeded_random": ("import random\nr = random.Random(3)\n",
                             SIM_PATH, "RPL001"),
    "rpl004_no_plan": (RPL004_STRATEGY_BAD, "src/repro/fed/x.py", "RPL004"),
    "rpl004_incomplete_plan": (RPL004_PLAN_INCOMPLETE, "src/repro/fed/x.py",
                               "RPL004"),
    "rpl004_complete_plan": (RPL004_STRATEGY_GOOD, "src/repro/fed/x.py",
                             "RPL004"),
    "rpl004_imported_base": (RPL004_IMPORTED_BASE, "src/repro/fed/x.py",
                             "RPL004"),
    "rpl004_codec_bad": (RPL004_CODEC_BAD, "examples/custom_codec.py",
                         "RPL004"),
    "rpl004_codec_good": (RPL004_CODEC_GOOD, "examples/custom_codec.py",
                          "RPL004"),
    "rpl004_vectorized_bad": (RPL004_VEC_BAD, "src/repro/edge/policies.py",
                              "RPL004"),
    "rpl004_vectorized_good": (RPL004_VEC_GOOD, "src/repro/edge/policies.py",
                               "RPL004"),
    "rpl005_bad": (RPL005_BAD, SIM_PATH, "RPL005"),
    "rpl005_good": (RPL005_GOOD, SIM_PATH, "RPL005"),
    "rpl005_early_out": (RPL005_EARLY_OUT, SIM_PATH, "RPL005"),
    "rpl005_alias": (RPL005_ALIAS, SIM_PATH, "RPL005"),
    "rpl005_other_receivers": (RPL005_OTHER_RECEIVERS, SIM_PATH, "RPL005"),
    "rpl006_bad": (RPL006_BAD, SIM_PATH, "RPL006"),
    "rpl006_good": (RPL006_GOOD, SIM_PATH, "RPL006"),
    "pragma_same_line": (_pragma("repro: allow[RPL001]"), SIM_PATH, "RPL001"),
    "pragma_line_above": (_pragma("repro: allow[RPL001]", above=True),
                          SIM_PATH, "RPL001"),
    "pragma_wrong_rule": (_pragma("repro: allow[RPL006]"), SIM_PATH,
                          "RPL001"),
    "pragma_star": (_pragma("repro: allow[*]"), SIM_PATH, None),
}


def _lint_case(name):
    src, path, rule = LINT_CASES[name]
    return lambda linter: where(lint_with(linter, src, path, rule))


def _one_finding(linter):
    (f,) = lint_with(linter, RPL006_BAD, rule="RPL006")
    return f


def _baseline_moved(linter, tmp_path, capsys):
    f = _one_finding(linter)
    bl = linter.core.Baseline.from_findings([f])
    moved = linter.core.Finding(f.rule, f.path, f.line + 40, f.col,
                                f.message, f.snippet)
    other = linter.core.Finding(f.rule, f.path, 3, 0, f.message,
                                "ledger.upload(z, 9)")
    out = []
    for g in (moved, other):
        fresh, eaten = bl.filter([g])
        out.append((where(fresh), eaten))
    return out


def _baseline_counts(linter, tmp_path, capsys):
    f = _one_finding(linter)
    fresh, eaten = linter.core.Baseline.from_findings([f]).filter([f, f])
    return where(fresh), eaten


def _baseline_disk(linter, tmp_path, capsys):
    f = _one_finding(linter)
    path = str(tmp_path / "bl.json")
    linter.core.Baseline.from_findings([f]).write(path)
    missing = linter.core.Baseline.load(str(tmp_path / "missing.json"))
    return (linter.core.Baseline.load(path).counts == {f.fingerprint(): 1},
            missing.counts)


def _write(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(textwrap.dedent(src))
    return str(p)


BAD_UPLOAD = "def f(ledger, d, k):\n    ledger.upload(d, k)\n"


def _cli_json(linter, tmp_path, capsys):
    bad = _write(tmp_path, "mod.py", BAD_UPLOAD)
    rc = linter.cli(["--format", "json", "--no-baseline", bad])
    payload = json.loads(capsys.readouterr().out)
    ok = _write(tmp_path, "ok.py", "x = 1\n")
    rc_ok = linter.cli(["--no-baseline", ok])
    capsys.readouterr()
    return (rc, rc_ok, payload["version"],
            set(payload["rules"]) == set(linter.core.names()),
            [(f["rule"], f["line"], f["col"], sorted(f))
             for f in payload["findings"]])


def _cli_baseline(linter, tmp_path, capsys):
    bad = _write(tmp_path, "mod.py", BAD_UPLOAD)
    bl = str(tmp_path / "baseline.json")
    rcs = [linter.cli(["--baseline", bl, "--write-baseline", bad]),
           linter.cli(["--baseline", bl, bad]),
           linter.cli(["--baseline", bl, "--no-baseline", bad])]
    capsys.readouterr()
    return rcs


def _cli_parse_error(linter, tmp_path, capsys):
    broken = _write(tmp_path, "broken.py", "def f(:\n")
    rc = linter.cli(["--format", "json", "--no-baseline", broken])
    payload = json.loads(capsys.readouterr().out)
    return rc, [(f["rule"], f["line"]) for f in payload["findings"]]


def _cli_unknown_rule(linter, tmp_path, capsys):
    with pytest.raises(SystemExit):
        linter.cli(["--select", "NOPE01", "src"])
    return True


def _run_paths_walks(linter, tmp_path, capsys):
    sub = tmp_path / "pkg"
    sub.mkdir()
    (sub / "a.py").write_text(BAD_UPLOAD)
    (sub / "b.txt").write_text("not python")
    return [(f.rule, f.line, f.col)
            for f in linter.core.run_paths([str(tmp_path)])]


OTHER_CASES = {
    "baseline_by_fingerprint_not_line": _baseline_moved,
    "baseline_counts_cap_duplicates": _baseline_counts,
    "baseline_roundtrips_through_disk": _baseline_disk,
    "cli_exit_codes_and_json_schema": _cli_json,
    "cli_baseline_workflow": _cli_baseline,
    "cli_parse_error_is_a_finding": _cli_parse_error,
    "cli_select_unknown_rule_errors": _cli_unknown_rule,
    "run_paths_walks_directories": _run_paths_walks,
}
PARITY = sorted(LINT_CASES) + sorted(OTHER_CASES)


@pytest.mark.parametrize("case", PARITY)
def test_reference_case_gives_the_same_findings(case, tmp_path, capsys):
    """Each reference case: the port's linter gives the reference's
    (rule, line, col) findings, exit codes and baseline arithmetic."""
    if case in LINT_CASES:
        run = _lint_case(case)
    else:
        def run(linter):
            sub = tmp_path / ("ref" if linter is REF else "port")
            sub.mkdir()
            return OTHER_CASES[case](linter, sub, capsys)
    assert run(PORT) == run(REF)


def test_parity_cases_fire_where_the_reference_suite_says():
    """The parity cases are not all quiet: the reference's counts hold on
    the port."""
    counts = {name: len(_lint_case(name)(PORT)) for name in LINT_CASES}
    assert counts["rpl001_bad"] == 2 and counts["rpl001_fed"] == 2
    assert counts["rpl001_datetime_random"] == 2
    assert counts["rpl004_no_plan"] == counts["rpl004_codec_bad"] == 1
    assert counts["rpl005_bad"] == 2 and counts["rpl006_bad"] == 1
    assert counts["pragma_wrong_rule"] == 1
    assert counts["rpl001_good"] == counts["pragma_star"] == 0


def test_registry_has_the_six_contract_rules():
    assert port_core.names() == ["RPL001", "RPL002", "RPL003", "RPL004",
                                 "RPL005", "RPL006"]
    for r in port_core.all_rules():
        assert r.id and r.title and r.description
    assert port_core.BASELINE_DEFAULT == "analysis-baseline-torch.json"


# ---------------------------------------------------------------------------
# RPL001: torch's process-wide generator
# ---------------------------------------------------------------------------
RPL001_TORCH_BAD = """\
    import torch

    def draw(x, n):
        a = torch.rand(n)
        b = torch.randn_like(x)
        c = torch.randint(0, 9, (n,))
        x.uniform_(-1.0, 1.0)
        torch.manual_seed(0)
        return torch.randperm(n), torch.multinomial(x, 2), a, b, c
"""
RPL001_TORCH_GOOD = """\
    import torch

    def draw(x, n, gen: torch.Generator):
        a = torch.rand(n, generator=gen)
        c = torch.randint(0, 9, (n,), generator=gen)
        x.uniform_(-1.0, 1.0, generator=gen)
        g2 = torch.Generator().manual_seed(0)
        return torch.randperm(n, generator=g2), torch.zeros_like(x), a, c
"""


def test_rpl001_fires_on_torch_global_rng():
    out = port_lint(RPL001_TORCH_BAD, "src/repro_torch/fed/x.py", "RPL001")
    assert out == [("RPL001", 4), ("RPL001", 5), ("RPL001", 6),
                   ("RPL001", 7), ("RPL001", 8), ("RPL001", 9),
                   ("RPL001", 9)]


def test_rpl001_quiet_on_torch_draws_with_a_generator():
    assert port_lint(RPL001_TORCH_GOOD, "src/repro_torch/edge/x.py",
                     "RPL001") == []


@pytest.mark.parametrize("path", ["src/repro_torch/models/x.py",
                                  "chip_smoke.py", "src/repro/edge/x.py"])
def test_rpl001_torch_draws_scoped_to_the_port_sim_paths(path):
    assert port_lint(RPL001_TORCH_BAD, path) == []


# ---------------------------------------------------------------------------
# RPL002: default-dtype / TF32 flips and the fleet backend's dtypes
# ---------------------------------------------------------------------------
RPL002_GLOBAL_BAD = """\
    import torch
    from torch.backends import cudnn

    torch.set_default_dtype(torch.float64)
    torch.backends.cuda.matmul.allow_tf32 = True
    cudnn.allow_tf32 = True
    if True:
        torch.set_float32_matmul_precision("high")
"""
RPL002_GLOBAL_GOOD = """\
    import torch

    def setup():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_default_dtype(torch.float32)

    if __name__ == "__main__":
        setup()
"""
RPL002_FLEET_BAD = """\
    import numpy as np
    import torch

    def _widths(x, n: int):
        lo = torch.zeros(())
        pow2 = torch.full((n,), 2.0, device=x.device)
        t = torch.as_tensor(np.asarray(x), device=x.device)
        return torch.arange(n), torch.tensor([1.0, 2.0]), lo, pow2, t
"""
RPL002_FLEET_GOOD = """\
    import numpy as np
    import torch

    _F64 = torch.float64

    def _widths(x, feas, n: int):
        lo = torch.zeros((), dtype=_F64, device=x.device)
        pow2 = torch.full((n,), 2.0, dtype=_F64, device=x.device)
        t = torch.as_tensor(np.asarray(x, dtype=np.float64), device=x.device)
        f = torch.as_tensor(np.asarray(feas, dtype=bool), device=x.device)
        k = torch.arange(n, dtype=torch.int64)
        return torch.full_like(lo, 1.0), torch.zeros_like(t), pow2, f, k
"""
FLEET_PATH = "src/repro_torch/edge/fleet/kernel.py"


def test_rpl002_fires_on_module_level_numerics_flips():
    out = port_lint(RPL002_GLOBAL_BAD, "src/repro_torch/models/x.py",
                    "RPL002")
    assert out == [("RPL002", 4), ("RPL002", 5), ("RPL002", 6),
                   ("RPL002", 8)]


def test_rpl002_quiet_on_flips_inside_functions():
    assert port_lint(RPL002_GLOBAL_GOOD, "chip_smoke.py", "RPL002") == []


def test_rpl002_fires_on_fleet_factories_without_dtype():
    assert port_lint(RPL002_FLEET_BAD, FLEET_PATH, "RPL002") == [
        ("RPL002", 5), ("RPL002", 6), ("RPL002", 7), ("RPL002", 8),
        ("RPL002", 8)]


def test_rpl002_quiet_on_fleet_factories_with_dtype():
    assert port_lint(RPL002_FLEET_GOOD, FLEET_PATH, "RPL002") == []


def test_rpl002_factory_dtypes_scoped_to_the_fleet():
    # outside edge/fleet/ only the module-level flips fire
    assert port_lint(RPL002_FLEET_BAD, "src/repro_torch/edge/runtime.py",
                     "RPL002") == []


# ---------------------------------------------------------------------------
# RPL003: no host syncs in the device bodies
# ---------------------------------------------------------------------------
RPL003_BAD = """\
    import numpy as np
    import torch

    def _step(w, budget, iters: int):
        if w.sum() > budget:
            w = w * 0.5
        total = float(torch.sum(w))
        peak = w.max().item()
        host = w.cpu()
        torch.cuda.synchronize()
        big = w[torch.argmax(w)]
        first = w[w.argmin()]
        r = np.asarray(w)
        assert budget > 0
        return w if budget else None, total, peak, host, big, first, r
"""
RPL003_GOOD = """\
    import torch

    def _step(w, budget, iters: int, scale: float, mode: str,
              device: torch.device, cols: list[int], half: tuple[int, ...],
              leaves: list[torch.Tensor], olds: list[torch.Tensor] | None):
        if iters > 3 and mode == "off":   # annotated scalars: host values
            w = w * scale
        if sum(-(-c // iters) for c in cols) <= 4 and any(half):
            w = w * 2.0
        if not leaves or olds is None or len(leaves) != len(cols):
            return w
        if w.shape[0] > 1 and w.dtype == torch.float64 and w.is_cuda:
            w = torch.where(torch.sum(w) > budget, w * 0.5, w)
        if leaves[0].dim() and leaves[0].numel() and w.device == device:
            w = w + leaves[0]
        B, D = w.shape
        first = torch.index_select(w, 0, torch.argmax(w, dim=0)[:1])
        return w[0], w[:, torch.argmax(w, dim=1)], first, min(64, D), int(B)
"""


def test_rpl003_fires_on_host_syncs_in_a_device_body():
    out = port_lint(RPL003_BAD, FLEET_PATH, "RPL003")
    assert out == [("RPL003", 5), ("RPL003", 7), ("RPL003", 8),
                   ("RPL003", 9), ("RPL003", 10), ("RPL003", 11),
                   ("RPL003", 12), ("RPL003", 13), ("RPL003", 14),
                   ("RPL003", 15)]


def test_rpl003_quiet_on_metadata_and_annotated_scalars():
    assert port_lint(RPL003_GOOD, FLEET_PATH, "RPL003") == []
    assert port_lint(RPL003_GOOD, "src/repro_torch/kernels/ops.py",
                     "RPL003") == []


def test_rpl003_fires_on_an_element_of_a_tensor_container():
    src = """\
        import torch

        def gram(leaves: list[torch.Tensor], k: int):
            if leaves[0].sum() > 0 or int(leaves[k]) > 1:
                return leaves[0]
            return None
    """
    assert port_lint(src, "src/repro_torch/kernels/vlbfgs.py", "RPL003") \
        == [("RPL003", 4), ("RPL003", 4)]


@pytest.mark.parametrize("path,name", [
    (FLEET_PATH, "step"),                           # a public *_jit wrapper
    ("src/repro_torch/kernels/ref.py", "_step"),    # the plain versions
    ("src/repro_torch/kernels/_build.py", "_step"),
    ("src/repro_torch/edge/runtime.py", "_step"),   # outside the scope
    ("src/repro/kernels/ops.py", "_step"),
])
def test_rpl003_only_in_device_bodies(path, name):
    assert port_lint(RPL003_BAD.replace("_step", name), path, "RPL003") == []


def test_rpl003_every_kernels_function_is_a_device_body():
    out = port_lint(RPL003_BAD.replace("_step", "launch"),
                    "src/repro_torch/kernels/codec_ops.py", "RPL003")
    assert len(out) == 10


# ---------------------------------------------------------------------------
# RPL005 on the train step's spans (launch/ and core/)
# ---------------------------------------------------------------------------
RPL005_SPAN_BAD = """\
    def step_body(tracer, step, j, xs):
        with tracer.wall_span(f"train.cohort.{j}", round_id=step):
            xs = [x + 1 for x in xs]
        with tracer.wall_span("server", round_id=step, sizes=[len(x) for x in xs]):
            return xs
"""
RPL005_SPAN_GOOD = """\
    def step_body(tracer, step, j, xs):
        with tracer.wall_span("train.cohort", round_id=step, cohort=j):
            xs = [x + 1 for x in xs]
        if tracer.enabled:
            tracer.event("sizes", "wall", 0.0, detail=f"{len(xs)}")
        return xs
"""


@pytest.mark.parametrize("path", ["src/repro_torch/launch/train.py",
                                  "src/repro_torch/core/fim_lbfgs.py"])
def test_rpl005_fires_on_an_eager_span_argument_in_the_train_step(path):
    assert port_lint(RPL005_SPAN_BAD, path, "RPL005") == [("RPL005", 2),
                                                          ("RPL005", 4)]
    assert port_lint(RPL005_SPAN_GOOD, path, "RPL005") == []


def test_rpl005_leaves_the_models_alone():
    assert port_lint(RPL005_SPAN_BAD, "src/repro_torch/models/model.py",
                     "RPL005") == []


# the parent's _bw_widths: line 77 of src/repro_torch/edge/fleet/kernel.py
# indexed the candidates by a 0-d argmax, a host read once a call
PARENT_BW_WIDTHS = """\
    import torch

    def _bw_widths(bits, s, tc, budget: float, iters: int):
        lo = torch.max(tc)
        hi = torch.maximum(2.0 * lo, lo + 1e-6)
        cands = hi * torch.ones(3, dtype=torch.float64)
        fits = cands <= budget
        fits[-1] = True
        hi = cands[torch.argmax(fits.to(torch.int8))]
        return hi
"""


def test_rpl003_catches_the_parent_fleet_sync():
    assert port_lint(PARENT_BW_WIDTHS, FLEET_PATH) == [("RPL003", 9)]


# ---------------------------------------------------------------------------
# the package stands alone, and the tree is clean
# ---------------------------------------------------------------------------
def test_analyzer_is_pure_stdlib():
    code = ("import sys; import repro_torch.analysis.cli; "
            "bad = [m for m in ('jax', 'torch', 'numpy', 'repro', "
            "'repro_torch.fed', 'repro_torch.edge') if m in sys.modules]; "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_runs_without_site_packages():
    """``-S``: no site-packages, so neither torch, numpy nor jax can
    load; the linter lists its rules all the same."""
    code = ("import runpy, sys; sys.path.insert(0, sys.argv[1]); "
            "sys.argv = ['repro_torch.analysis', '--list-rules']; "
            "runpy.run_module('repro_torch.analysis', run_name='__main__')")
    proc = subprocess.run([sys.executable, "-S", "-c", code,
                           str(ROOT / "src")], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [line.split()[0] for line in proc.stdout.splitlines()] == [
        "RPL001", "RPL002", "RPL003", "RPL004", "RPL005", "RPL006"]


def _lint_tree(*flags):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *flags,
         "src/repro_torch", "chip_smoke.py", "examples", "tools"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_port_tree_is_clean_under_its_baseline():
    """The acceptance gate, as a test: the port's files lint clean
    against analysis-baseline-torch.json, and clean without it too: the
    baseline grandfathers nothing (the export timestamp went with
    ``write_bench_json``)."""
    proc = _lint_tree()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _lint_tree("--no-baseline", "--format", "json")
    assert json.loads(proc.stdout)["findings"] == []
    baseline = json.loads((ROOT / "analysis-baseline-torch.json").read_text())
    assert baseline["findings"] == {}
