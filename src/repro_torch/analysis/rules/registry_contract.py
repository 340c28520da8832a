"""RPL004 — registry-contract: registered plugins declare what the
generic drivers consume.

The three registries (strategies / codecs / allocation policies) let
anyone drop in a new entry without driver edits — which also means a
structurally incomplete entry only fails deep inside a round.  This
rule front-loads the three declaration contracts:

  * a class registered with ``repro_torch.fed.strategies`` must carry a
    ``_make_plan`` that constructs a complete ``RoundPlan`` (both
    ``phases`` and ``flops`` — the inputs CommLedger metering, edge
    estimation, and scheduling all consume);
  * a class registered with ``repro_torch.fed.codecs`` must define
    ``wire_bytes`` (the single number that keeps plan == ledger);
  * any class defining ``decide_vectorized`` must match the
    ``FleetRoundState -> Optional[FleetDecision]`` shape: exactly
    ``(self, fstate)``, no varargs — the fleet fast path calls it
    positionally with one state.

Resolution is per-module: base classes imported from elsewhere are
assumed compliant (their defining module is linted on its own).  The
port of ``repro.analysis.rules.registry_contract``: the same contracts,
with the register functions and protocol roots of ``repro_torch``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ModuleSource, Rule, register

STRATEGY_REGISTERS = {"repro_torch.fed.strategies.base.register",
                      "repro_torch.fed.strategies.register",
                      "strategies.register"}
CODEC_REGISTERS = {"repro_torch.fed.codecs.register", "codecs.register"}
POLICY_REGISTERS = {"repro_torch.edge.allocation.register",
                    "allocation.register"}

# a bare `register` defined in the file itself: classify by the file
_SELF_KINDS = (("fed/strategies/", "strategy"), ("fed/codecs", "codec"),
               ("edge/allocation", "policy"))

# the protocol roots only *declare* the contract (abstract methods):
# inheriting from one of these is not evidence the method exists
ABSTRACT_ROOTS = {
    "repro_torch.fed.strategies.base.FedStrategy",
    "repro_torch.fed.strategies.FedStrategy",
    "repro_torch.fed.codecs.PayloadCodec",
    "repro_torch.edge.allocation.AllocationPolicy",
    "abc.ABC", "ABC", "object",
}


def _local_classes(mod: ModuleSource) -> dict:
    return {n.name: n for n in ast.walk(mod.tree)
            if isinstance(n, ast.ClassDef)}


def _mro_chain(mod: ModuleSource, cls: ast.ClassDef):
    """(same-module class chain, saw_imported_base) — depth-first over
    bases resolvable in this module."""
    classes = _local_classes(mod)
    chain, imported, stack, seen = [], False, [cls], set()
    while stack:
        c = stack.pop(0)
        if c.name in seen:
            continue
        seen.add(c.name)
        chain.append(c)
        for base in c.bases:
            name = base.id if isinstance(base, ast.Name) else None
            if name in classes:
                stack.append(classes[name])
                continue
            resolved = mod.resolve(base)
            if resolved in ABSTRACT_ROOTS or name == "object":
                continue  # the protocol root declares, never implements
            imported = True  # an unknown concrete base: trust it
    return chain, imported


def _find_method(chain, name: str):
    for c in chain:
        for item in c.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name == name:
                return item
    return None


@register
class RegistryContractRule(Rule):
    id = "RPL004"
    title = "registry-contract"
    description = ("registered strategies declare a complete RoundPlan, "
                   "registered codecs define wire_bytes, and "
                   "decide_vectorized matches the fleet signature")

    def check(self, mod: ModuleSource) -> list:
        out = []
        for cls, kind, site in self._registrations(mod):
            if kind == "strategy":
                out.extend(self._check_strategy(mod, cls, site))
            elif kind == "codec":
                out.extend(self._check_codec(mod, cls, site))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                m = _find_method([node], "decide_vectorized")
                if m is not None:
                    out.extend(self._check_vectorized_sig(mod, node, m))
        return out

    # -- find register call sites ---------------------------------------
    def _register_kind(self, mod: ModuleSource, func: ast.AST):
        d = mod.resolve(func)
        if d in STRATEGY_REGISTERS:
            return "strategy"
        if d in CODEC_REGISTERS:
            return "codec"
        if d in POLICY_REGISTERS:
            return "policy"
        if d == "register":  # defined in this very module
            for frag, kind in _SELF_KINDS:
                if frag in mod.path:
                    return kind
        return None

    def _registrations(self, mod: ModuleSource):
        classes = _local_classes(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for dec in node.decorator_list:
                    if isinstance(dec, ast.Call):
                        kind = self._register_kind(mod, dec.func)
                        if kind:
                            yield node, kind, node
            elif isinstance(node, ast.Call) and len(node.args) >= 2:
                kind = self._register_kind(mod, node.func)
                cls = node.args[1]
                if kind and isinstance(cls, ast.Name) \
                        and cls.id in classes:
                    yield classes[cls.id], kind, node

    # -- contracts -------------------------------------------------------
    def _check_strategy(self, mod, cls, site) -> list:
        chain, imported = _mro_chain(mod, cls)
        make_plan = _find_method(chain, "_make_plan")
        if make_plan is None:
            if imported:  # plan may live on the imported base — its
                return []  # module is linted separately
            return [self.finding(
                mod, site,
                f"registered strategy {cls.name} declares no _make_plan "
                "— the driver cannot meter/estimate/schedule it")]
        plan_calls = [n for n in ast.walk(make_plan)
                      if isinstance(n, ast.Call)
                      and (mod.resolve(n.func) or "").split(".")[-1]
                      == "RoundPlan"]
        if not plan_calls:
            return [self.finding(
                mod, make_plan,
                f"{cls.name}._make_plan never constructs a RoundPlan")]
        out = []
        for call in plan_calls:
            given = {kw.arg for kw in call.keywords if kw.arg}
            # positional slots are (phases, flops, ...)
            if len(call.args) >= 1:
                given.add("phases")
            if len(call.args) >= 2:
                given.add("flops")
            if any(kw.arg is None for kw in call.keywords):
                continue  # **kwargs splat: cannot prove incompleteness
            missing = [f for f in ("phases", "flops") if f not in given]
            if missing:
                out.append(self.finding(
                    mod, call,
                    f"{cls.name}._make_plan builds an incomplete "
                    f"RoundPlan: missing {', '.join(missing)} — metering "
                    "and edge scheduling consume both"))
        return out

    def _check_codec(self, mod, cls, site) -> list:
        chain, imported = _mro_chain(mod, cls)
        if _find_method(chain, "wire_bytes") is not None or imported:
            return []
        return [self.finding(
            mod, site,
            f"registered codec {cls.name} defines no wire_bytes — "
            "CommLedger metering, uplink time/energy, and scheduler "
            "estimates all consume it (plan == ledger breaks)")]

    def _check_vectorized_sig(self, mod, cls, m) -> list:
        a = m.args
        params = [p.arg for p in (a.posonlyargs + a.args)]
        problems = []
        if a.vararg or a.kwarg or a.kwonlyargs:
            problems.append("varargs/kw-only params")
        if len(params) != 2:
            problems.append(f"{len(params)} positional params (need 2)")
        if not problems:
            return []
        return [self.finding(
            mod, m,
            f"{cls.name}.decide_vectorized({', '.join(params)}) does not "
            "match the fleet contract decide_vectorized(self, fstate: "
            "FleetRoundState) -> Optional[FleetDecision] — the runtime "
            f"calls it positionally with one state ({'; '.join(problems)})")]
