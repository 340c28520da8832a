"""The port stands alone: ``repro_torch``, ``chip_smoke.py``, the port's
examples and ``tools/`` import neither JAX nor the reference package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


# modules of the LLM serving slice, named so that a missing one fails
LLM_MODULES = ["repro_torch.configs.granite_8b", "repro_torch.configs.granite_20b",
               "repro_torch.configs.phi4_mini", "repro_torch.configs.qwen3_32b",
               "repro_torch.configs.hubert_xlarge",
               "repro_torch.configs.chameleon_34b",
               "repro_torch.kernels.flash_attention", "repro_torch.launch.train",
               "repro_torch.models.layers", "repro_torch.models.attention",
               "repro_torch.models.transformer", "repro_torch.models.model",
               "repro_torch.utils.device"]
# modules of the edge and observability slice
EDGE_MODULES = ["repro_torch.edge", "repro_torch.edge.allocation",
                "repro_torch.edge.async_agg", "repro_torch.edge.channel",
                "repro_torch.edge.device", "repro_torch.edge.events",
                "repro_torch.edge.runtime", "repro_torch.edge.scheduler",
                "repro_torch.edge.scenario",
                "repro_torch.edge.scenario.availability",
                "repro_torch.edge.scenario.base",
                "repro_torch.edge.scenario.faults", "repro_torch.obs",
                "repro_torch.obs.export", "repro_torch.obs.metrics",
                "repro_torch.obs.trace"]
# modules of the checkpoint, cohort-simulator and fleet-engine slice
FLEET_MODULES = ["repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
                 "repro_torch.checkpoint.run_state", "repro_torch.fed.simulator",
                 "repro_torch.edge.fleet", "repro_torch.edge.fleet.engine",
                 "repro_torch.edge.fleet.kernel", "repro_torch.edge.fleet.state"]


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py"))
            + sorted((ROOT / "tools").glob("*.py")))


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    """AST scan: no ``import jax``/``from jax ...`` and no ``repro`` import
    (``repro_torch`` is a different root and allowed)."""
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_with_jax_blocked():
    """Import every repro_torch module in a fresh interpreter where
    ``import jax`` fails; afterwards no ``repro`` module is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "leaked = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not leaked, leaked\n"
        f"missing = set({LLM_MODULES + EDGE_MODULES + FLEET_MODULES!r}) "
        "- set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 75, names\n"
        "print(len(names))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
