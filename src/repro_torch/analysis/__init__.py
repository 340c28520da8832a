"""repro_torch.analysis — the port's runtime contracts as static AST checks.

The port of ``repro.analysis``: the same engine, rule ids, pragmas and
CLI, with each rule pointed at ``src/repro_torch`` and recast where JAX
has no meaning in torch:

  ======== ================== ==============================================
  RPL001   sim-determinism    no wall clocks / global RNG (random.*,
                              np.random.<fn>, torch draws without
                              generator=, torch.manual_seed) in
                              repro_torch/{edge,fed,obs}
  RPL002   x64-hygiene        no module-level default-dtype / TF32 flip;
                              torch factories in edge/fleet/ pass dtype=
  RPL003   jit-purity         no host syncs (.item(), .cpu(), float(t),
                              branching on values, 0-d-reduction indexing)
                              in the fleet kernel's and kernels/' device
                              bodies
  RPL004   registry-contract  registered strategies/codecs/policies declare
                              what the generic drivers consume
  RPL005   tracer-noop        telemetry work is skipped, not discarded,
                              under NULL_TRACER
  RPL006   ledger-discipline  every upload billed at explicit wire_bytes
  ======== ================== ==============================================

CLI: ``python -m repro_torch.analysis [--format text|json] [--baseline
FILE] [paths...]`` (default path ``src/repro_torch``, default baseline
``analysis-baseline-torch.json``).  Suppress one site with ``# repro:
allow[RPL001]``; grandfather existing findings into the committed
baseline with ``--write-baseline``.  The package is pure stdlib and
never imports the modules it lints.
"""
from repro_torch.analysis.core import (Baseline, Finding,  # noqa: F401
                                       ModuleSource, Rule, all_rules,
                                       check_module, get, names, register,
                                       run_paths)
