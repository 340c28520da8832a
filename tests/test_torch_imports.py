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
# modules of the MoE, Mamba-2 and hybrid slice
FAMILY_MODULES = ["repro_torch.configs.qwen3_moe_235b",
                  "repro_torch.configs.dbrx_132b",
                  "repro_torch.configs.mamba2_370m",
                  "repro_torch.configs.jamba_52b", "repro_torch.models.moe",
                  "repro_torch.models.mamba2", "repro_torch.models.hybrid"]
# modules of the checkpoint, cohort-simulator and fleet-engine slice
FLEET_MODULES = ["repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
                 "repro_torch.checkpoint.run_state", "repro_torch.fed.simulator",
                 "repro_torch.edge.fleet", "repro_torch.edge.fleet.engine",
                 "repro_torch.edge.fleet.kernel", "repro_torch.edge.fleet.state"]
# modules of the sharding and dry-run slice
SHARD_MODULES = ["repro_torch.utils.sharding", "repro_torch.launch.mesh",
                 "repro_torch.launch.cost", "repro_torch.launch.dryrun"]


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
        f"missing = set({LLM_MODULES + EDGE_MODULES + FLEET_MODULES + FAMILY_MODULES + SHARD_MODULES!r}) "
        "- set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 86, names\n"
        "print(len(names))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# entry points of the LLM train-step slice, by module
TRAIN_NAMES = {
    "repro_torch.launch.train": ["make_train_step", "init_train_state",
                                 "opt_config", "make_prefill_step",
                                 "make_serve_step"],
    "repro_torch.models.transformer": ["_chunked_ce", "lm_loss",
                                       "encoder_loss", "loss_fn"],
    "repro_torch.models.model": ["loss_fn", "synth_batch"],
    "repro_torch.models.layers": ["rms_norm"],
    "repro_torch.utils.pytree": ["tree_scale", "tree_add", "tree_sub",
                                 "tree_mul", "tree_zeros_like",
                                 "tree_ones_like", "tree_cast", "tree_size",
                                 "tree_stack_init", "tree_stack_push",
                                 "tree_stack_index"],
    "repro_torch.core.lbfgs": ["push_"],
    "repro_torch.core.fim": ["update_"],
    "repro_torch.kernels.ref": ["vlbfgs_gram_leaves_ref"],
    "repro_torch.models.moe": ["moe_init", "_capacity", "moe_apply", "route",
                               "assign_slots", "dispatch", "expert_ffn",
                               "combine"],
    "repro_torch.models.mamba2": ["mamba_init", "_split_proj", "_causal_conv",
                                  "MambaState", "state_init", "mamba_apply",
                                  "mamba_decode"],
    "repro_torch.models.hybrid": ["init_params", "_mm_block", "_ma_block",
                                  "forward", "lm_loss", "HybridCache",
                                  "init_cache", "decode_step"],
}
# the sharding slice: the rules, the axes trees, the meshes, the shape
# helpers, the sharded step and the dry run (merged into TRAIN_NAMES
# below, module by module)
SHARDING_NAMES = {
    "repro_torch.models.hybrid": ["param_axes", "cache_axes"],
    "repro_torch.utils.sharding": ["DEFAULT_RULES", "OPT_RULES",
                                   "PARAM_RULES_FSDP", "parse_axes",
                                   "spec_for", "specs_for_tree", "data_spec",
                                   "placements_for", "distribute",
                                   "distribute_tree", "LeafSum",
                                   "mesh_all_reduce"],
    "repro_torch.launch.mesh": ["make_mesh", "make_production_mesh",
                                "make_debug_mesh",
                                "fake_process_group", "PEAK_FLOPS_BF16",
                                "HBM_BW", "NVLINK_BW"],
    "repro_torch.launch.cost": ["CostCounter"],
    "repro_torch.launch.dryrun": ["run_one", "run_step", "main"],
    "repro_torch.models.layers": ["use_mesh", "constrain", "mlp_axes"],
    "repro_torch.models.attention": ["attn_axes", "cache_axes"],
    "repro_torch.models.mamba2": ["mamba_axes", "state_axes"],
    "repro_torch.models.moe": ["moe_axes", "moe_apply_expert_parallel"],
    "repro_torch.models.transformer": ["param_axes", "cache_axes"],
    "repro_torch.models.model": ["param_axes", "cache_axes", "input_specs",
                                 "input_axes"],
    "repro_torch.core.fim_lbfgs": ["state_axes"],
    "repro_torch.core.baselines": ["adam_axes", "sgd_axes", "make"],
    "repro_torch.core.fedova": ["init", "binary_labels", "client_class_mask",
                                "add_class"],
    "repro_torch.data.partition": ["labels_per_client"],
    "repro_torch.data.synthetic": ["batches"],
    "repro_torch.kernels.ops": ["vlbfgs_gram_leaves_sharded"],
    "repro_torch.core.lbfgs": ["gram"],
    "repro_torch.configs": ["ASSIGNED"],
    "repro_torch.launch.train": ["abstract_params", "train_state_shapes",
                                 "abstract_cache", "train_state_axes",
                                 "shard_train_state", "shard_batch"],
}
for _module, _names in SHARDING_NAMES.items():
    TRAIN_NAMES.setdefault(_module, []).extend(_names)


def test_train_slice_entry_points_import_with_jax_blocked():
    """The train step's modules import, and carry their entry points, in
    a fresh interpreter where ``import jax`` fails; the example that drives
    them runs its argument parser there too."""
    code = (
        "import importlib, runpy, sys\n"
        "sys.modules['jax'] = None\n"
        f"names = {TRAIN_NAMES!r}\n"
        "for mod, attrs in names.items():\n"
        "    m = importlib.import_module(mod)\n"
        "    missing = [a for a in attrs if not hasattr(m, a)]\n"
        "    assert not missing, (mod, missing)\n"
        "sys.argv = ['torch_llm_fed_train.py', '--help']\n"
        "try:\n"
        f"    runpy.run_path({str(ROOT / 'examples' / 'torch_llm_fed_train.py')!r},"
        " run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "leaked = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not leaked, leaked\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dryrun_builds_a_record_with_jax_blocked():
    """``python -m repro_torch.launch.dryrun``'s machinery imports and
    builds one record (a smoke config's prefill on a fake 16 x 16 mesh of
    256 ranks) in an interpreter where ``import jax`` fails; its argument
    parser runs there too."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.configs import granite_8b\n"
        "from repro_torch.configs.base import ShapeConfig\n"
        "from repro_torch.launch import dryrun, mesh\n"
        "try:\n"
        "    dryrun.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "mesh.fake_process_group(256)\n"
        "rec = dryrun.run_one('granite-smoke', None, False,\n"
        "    cfg=granite_8b.smoke_config(),\n"
        "    shape=ShapeConfig('smoke_prefill', 64, 16, 'prefill'))\n"
        "assert rec['status'] == 'ok' and rec['param_bytes'] > 0, rec\n"
        "assert rec['flops_global'] > 0, rec\n"
        "leaked = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not leaked, leaked\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
