"""RPL001 — sim-determinism: no wall clocks or global RNG in sim paths.

The determinism suite proves same-seed replays are bit-identical, but
only on the paths it exercises.  This rule makes the contract
structural: inside ``src/repro_torch/{edge,fed,obs}`` every random draw
must come from an explicitly seeded generator
(``np.random.default_rng(seed)``, a ``torch.Generator`` passed as
``generator=``) and every timestamp from the simulated ``EventClock`` —
never from the host.

The port of ``repro.analysis.rules.determinism``: the same wall-clock,
``datetime.now``, ``random.*`` and ``np.random.<fn>`` checks, plus
torch's process-wide generator, which every draw below reads unless it
is handed ``generator=``:

  * ``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
    ``multinomial``/``normal`` without ``generator=``;
  * ``torch.rand_like``/``randn_like``/``randint_like``, which take no
    ``generator=`` and so always draw from it;
  * the in-place draws ``Tensor.uniform_``/``normal_``/``bernoulli_``/
    ``random_``/``exponential_`` without ``generator=``;
  * ``torch.manual_seed``/``torch.seed``, which reseed it for the whole
    process.

Opt-in wall-clock measurement (the tracer's ``CAT_WALL`` timeline, the
traced codec timing) marks itself with ``# repro: allow[RPL001]`` so
the exception is visible at the call site.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ModuleSource, Rule, register

SIM_PATHS = ("repro_torch/edge/", "repro_torch/fed/", "repro_torch/obs/")

WALL_CLOCKS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
}
DATETIME_NOW = {
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "date.today", "datetime.date.today",
}
# random.Random(seed) is an explicitly seeded generator object — allowed
RANDOM_ALLOWED = {"Random"}
# the seeded Generator construction surface of numpy.random — allowed
NP_RANDOM_ALLOWED = {"default_rng", "Generator", "SeedSequence", "PCG64",
                     "PCG64DXSM", "Philox", "MT19937", "SFC64",
                     "BitGenerator"}
# torch draws that read the global generator unless given generator=
TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli",
               "multinomial", "normal"}
# torch draws that take no generator= at all
TORCH_GLOBAL_ONLY = {"rand_like", "randn_like", "randint_like"}
# in-place Tensor draws, matched by method name on any receiver
INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_"}
TORCH_RESEED = {"torch.manual_seed", "torch.seed"}


def _passes_generator(call: ast.Call) -> bool:
    return any(kw.arg in ("generator", None) for kw in call.keywords)


@register
class SimDeterminismRule(Rule):
    id = "RPL001"
    title = "sim-determinism"
    description = ("no wall clocks (time.time/datetime.now) or global RNG "
                   "(random.*, np.random.<fn>, torch draws without "
                   "generator=, torch.manual_seed) in "
                   "src/repro_torch/{edge,fed,obs} — sim paths must replay "
                   "bit-identically")

    def applies_to(self, path: str) -> bool:
        return any(seg in path for seg in SIM_PATHS)

    def check(self, mod: ModuleSource) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = self._classify_inplace(node)
            d = mod.resolve(node.func)
            if msg is None and d is not None:
                msg = self._classify(d, node)
            if msg is not None:
                out.append(self.finding(mod, node, msg))
        return out

    def _classify_inplace(self, node: ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in INPLACE_DRAWS \
                and not _passes_generator(node):
            return (f".{node.func.attr}() without generator= draws from "
                    "torch's process-wide RNG — pass a seeded "
                    "torch.Generator")
        return None

    def _classify(self, d: str, node: ast.Call):
        if d in WALL_CLOCKS:
            return (f"wall-clock call {d}() in a sim path — simulated time "
                    "comes from EventClock; opt-in CAT_WALL measurement "
                    "sites take `# repro: allow[RPL001]`")
        if d in DATETIME_NOW:
            return (f"{d}() reads the host clock in a sim path — replays "
                    "must be bit-identical")
        if d in TORCH_RESEED:
            return (f"{d}() reseeds torch's process-wide RNG — seed a "
                    "torch.Generator of your own instead")
        head, _, fn = d.partition(".")
        if head == "torch" and fn in TORCH_GLOBAL_ONLY:
            return (f"torch.{fn}() always draws from torch's process-wide "
                    "RNG (it takes no generator=) — draw with torch.rand/"
                    "randn(..., generator=) instead")
        if head == "torch" and fn in TORCH_DRAWS \
                and not _passes_generator(node):
            return (f"torch.{fn}() without generator= draws from torch's "
                    "process-wide RNG — pass a seeded torch.Generator")
        if head == "random" and fn and "." not in fn \
                and fn not in RANDOM_ALLOWED:
            return (f"global random.{fn}() draws from the process-wide RNG "
                    "— use a seeded np.random.default_rng / "
                    "torch.Generator stream")
        if d.startswith(("np.random.", "numpy.random.")):
            fn = d.split(".")[-1]
            if fn not in NP_RANDOM_ALLOWED:
                return (f"np.random.{fn}() uses the legacy global numpy "
                        "RNG — draw from a seeded Generator instead")
        return None
