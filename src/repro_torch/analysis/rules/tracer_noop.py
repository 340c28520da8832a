"""RPL005 — tracer-noop: tracing must cost ~nothing when it is off.

The default tracer is the shared no-op ``NULL_TRACER``; the runtime
contract (tests/test_observability.py) is that untraced runs are
byte-identical *and* pay only an attribute check per instrumented site.
That breaks silently whenever a call site eagerly builds its telemetry
— an f-string, a ``%``/``.format`` render, a dict/comprehension — as an
argument, because Python evaluates arguments before the no-op method
discards them.

This rule flags tracer/metrics/audit recording calls in
``repro_torch/edge``, ``repro_torch/fed`` and the LLM train step's
``repro_torch/launch`` and ``repro_torch/core`` (its ``wall_span`` sites)
whose arguments contain eager formatting or container building, unless
the call is guarded:

  * lexically inside ``if <...>.enabled:`` (or the else-branch of
    ``if not <...>.enabled:``), or
  * after an early-out ``if not <...>.enabled: return/continue`` at the
    top level of the enclosing function.

Helpers that are *only called* under a guard (e.g. a ``_trace_*``
method) document that contract with ``# repro: allow[RPL005]``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ModuleSource, Rule, register

HOT_PATHS = ("repro_torch/edge/", "repro_torch/fed/", "repro_torch/launch/",
             "repro_torch/core/")

# unambiguous Tracer recording methods
TRACER_METHODS = {"span", "event", "record_round", "log_round", "wall_span"}
# metrics/audit methods — only tracer-ish when the receiver chain says so
METRIC_METHODS = {"counter", "gauge", "histogram", "inc", "observe", "set",
                  "add"}
RECEIVER_HINTS = {"tracer", "metrics", "audit"}


def _chain_parts(node: ast.AST) -> list:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.extend(_chain_parts(node.func))
    return parts


def _is_eager(node: ast.AST) -> bool:
    """Does this argument expression do formatting / container-building
    work that a no-op receiver would throw away?"""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.JoinedStr, ast.Dict, ast.DictComp,
                            ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return True
        if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Mod) \
                and isinstance(sub.left, (ast.Constant, ast.JoinedStr)) \
                and isinstance(getattr(sub.left, "value", None), str):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr == "format":
            return True
    return False


def _test_mentions_enabled(test: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "enabled"
               for n in ast.walk(test))


def _branch_of(mod: ModuleSource, if_node: ast.If, node: ast.AST) -> str:
    """'body' | 'orelse' | '' — which arm of ``if_node`` contains
    ``node``."""
    child = node
    for anc in mod.ancestors(node):
        if anc is if_node:
            break
        child = anc
    if child in if_node.body:
        return "body"
    if child in if_node.orelse:
        return "orelse"
    return ""


class _EnabledGuard:
    """Shared guard analysis: is this call site reachable only when
    tracing is enabled?"""

    def __init__(self, mod: ModuleSource):
        self.mod = mod

    def guarded(self, node: ast.AST) -> bool:
        for anc in self.mod.ancestors(node):
            if isinstance(anc, ast.If) and _test_mentions_enabled(anc.test):
                negated = isinstance(anc.test, ast.UnaryOp) \
                    and isinstance(anc.test.op, ast.Not)
                branch = _branch_of(self.mod, anc, node)
                if branch == ("orelse" if negated else "body"):
                    return True
        return self._after_early_out(node)

    def _after_early_out(self, node: ast.AST) -> bool:
        fn = self.mod.enclosing_function(node)
        if fn is None:
            return False
        # the top-level statement of fn.body that (transitively) holds node
        holder = node
        for anc in self.mod.ancestors(node):
            if anc is fn:
                break
            holder = anc
        for stmt in fn.body:
            if stmt is holder:
                return False
            if isinstance(stmt, ast.If) and _test_mentions_enabled(stmt.test) \
                    and isinstance(stmt.test, ast.UnaryOp) \
                    and isinstance(stmt.test.op, ast.Not) \
                    and stmt.body \
                    and all(isinstance(s, (ast.Return, ast.Continue,
                                           ast.Raise)) for s in stmt.body):
                return True
        return False


@register
class TracerNoopRule(Rule):
    id = "RPL005"
    title = "tracer-noop"
    description = ("no eager f-string/%-format/dict building passed into "
                   "Tracer/metrics calls outside an `.enabled` guard — "
                   "NULL_TRACER must skip the work, not discard it")

    def applies_to(self, path: str) -> bool:
        return any(seg in path for seg in HOT_PATHS)

    def check(self, mod: ModuleSource) -> list:
        guard = _EnabledGuard(mod)
        out = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            if attr in TRACER_METHODS:
                pass
            elif attr in METRIC_METHODS:
                parts = set(_chain_parts(node.func.value))
                if not (parts & RECEIVER_HINTS
                        or parts & self._aliases(mod, node)):
                    continue
            else:
                continue
            eager = [a for a in list(node.args)
                     + [kw.value for kw in node.keywords]
                     if _is_eager(a)]
            if not eager or guard.guarded(node):
                continue
            out.append(self.finding(
                mod, node,
                f"eager formatting/container building passed into "
                f".{attr}() without an `.enabled` guard — under "
                "NULL_TRACER this work runs and is thrown away; wrap the "
                "site in `if tracer.enabled:` (helpers called only under "
                "a guard take `# repro: allow[RPL005]`)"))
        return out

    def _aliases(self, mod: ModuleSource, node: ast.AST) -> set:
        """Local names assigned from tracer-ish chains in the enclosing
        function (``m = self.tracer.metrics``; ``c = tr.metrics.counter(
        ...)``) — resolved flow-insensitively, which is fine for a hint."""
        fn = mod.enclosing_function(node)
        if fn is None:
            return set()
        names = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) \
                    and set(_chain_parts(sub.value)) & RECEIVER_HINTS:
                for tgt in sub.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
        return names
