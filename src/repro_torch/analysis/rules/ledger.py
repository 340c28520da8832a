"""RPL006 — ledger-discipline: every upload is billed at its declared
wire size.

``plan == ledger`` (audited at runtime by ``PlanAudit``) holds
because every ``CommLedger.upload`` call site passes the
codec's ``wire_bytes`` explicitly instead of letting the ledger fall
back to ``n_floats * 4``: a new call site that omits it silently bills
uncompressed bytes and the Theorem-3 byte accounting drifts from what
actually crossed the wire.

The receiver is matched by method name (``.upload`` /
``.upload_per_client``), which is deliberate: the repo has exactly one
``upload`` API, and a false positive on some future unrelated
``.upload`` is one pragma away.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ModuleSource, Rule, register


@register
class LedgerDisciplineRule(Rule):
    id = "RPL006"
    title = "ledger-discipline"
    description = ("every CommLedger.upload/upload_per_client call passes "
                   "explicit wire_bytes — plan == ledger stays auditable "
                   "under every codec")

    def check(self, mod: ModuleSource) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            kwargs = {kw.arg for kw in node.keywords}
            if None in kwargs:  # **kwargs splat: cannot prove the omission
                continue
            if attr == "upload" and "wire_bytes" not in kwargs:
                out.append(self.finding(
                    mod, node,
                    ".upload() without explicit wire_bytes= bills the "
                    "4-byte-float fallback — pass the phase codec's "
                    "wire_bytes(up_floats) so plan == ledger holds under "
                    "every codec"))
            elif attr == "upload_per_client" and not node.args \
                    and "wire_bytes" not in kwargs:
                out.append(self.finding(
                    mod, node,
                    ".upload_per_client() without per-client wire_bytes "
                    "— pass the billed byte array/list explicitly"))
        return out
