"""RPL002 — x64-hygiene: keep float64 a *scoped* choice.

The reference keeps x64 an explicitly scoped property of the fleet fast
path (``with enable_x64():`` at its call sites, never a module-level
``jax.config.update``).  The port of ``repro.analysis.rules.x64``
carries the same contract in torch's idiom, where precision is a
per-tensor dtype and the process-wide switches are the default dtype
and the TF32 flags:

  * no process-wide numerics flip at module level anywhere in the linted
    tree: a call to ``torch.set_default_dtype``/
    ``set_default_tensor_type``/``set_float32_matmul_precision``, or an
    assignment to ``torch.backends.cuda.matmul.allow_tf32``/
    ``torch.backends.cudnn.allow_tf32``.  Importing such a module would
    change every other kernel's numerics; the same flip inside a function (the
    port turns TF32 off where it sets up a card) is legal, as
    ``jax.config.update`` inside a function is in the reference;
  * in ``edge/fleet/`` files every torch tensor factory (``zeros``,
    ``ones``, ``full``, ``empty``, ``arange``, ``linspace``, ``tensor``,
    ``as_tensor``) passes an explicit ``dtype=``, so the float64 backend
    never drops to the float32 default.  For ``tensor``/``as_tensor`` a
    ``dtype=`` on a directly wrapped ``np.asarray(...)``/``np.array(...)``
    counts too; ``*_like`` factories inherit their dtype and pass.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ModuleSource, Rule, register

GLOBAL_CALLS = {"torch.set_default_dtype", "torch.set_default_tensor_type",
                "torch.set_float32_matmul_precision"}
GLOBAL_FLAGS = {"torch.backends.cuda.matmul.allow_tf32",
                "torch.backends.cudnn.allow_tf32"}
FACTORIES = {"zeros", "ones", "full", "empty", "arange", "linspace",
             "tensor", "as_tensor"}
WRAPPING = {"tensor", "as_tensor"}
NP_ARRAYS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array"}


def _has_dtype(call: ast.Call) -> bool:
    return any(kw.arg in ("dtype", None) for kw in call.keywords)


@register
class X64HygieneRule(Rule):
    id = "RPL002"
    title = "x64-hygiene"
    description = ("no module-level torch default-dtype/TF32 flip; torch "
                   "tensor factories in edge/fleet/ pass an explicit dtype= "
                   "(float64 stays a scoped choice)")

    def check(self, mod: ModuleSource) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call) and mod.at_module_level(node) \
                    and mod.resolve(node.func) in GLOBAL_CALLS:
                out.append(self.finding(
                    mod, node,
                    f"module-level {mod.resolve(node.func)}() flips "
                    "numerics for the whole process on import — set it "
                    "inside the function that needs it, or pass dtype="))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                    and mod.at_module_level(node):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    flag = mod.resolve(tgt)
                    if flag in GLOBAL_FLAGS:
                        out.append(self.finding(
                            mod, node,
                            f"module-level assignment to {flag} flips "
                            "numerics for the whole process on import — "
                            "set it where a card is set up"))
        if "edge/fleet/" in mod.path:
            out.extend(self._check_fleet_dtypes(mod))
        return out

    def _check_fleet_dtypes(self, mod: ModuleSource) -> list:
        out = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            head, _, fn = (mod.resolve(node.func) or "").partition(".")
            if head != "torch" or fn not in FACTORIES or _has_dtype(node):
                continue
            if fn in WRAPPING and node.args \
                    and isinstance(node.args[0], ast.Call) \
                    and mod.resolve(node.args[0].func) in NP_ARRAYS \
                    and _has_dtype(node.args[0]):
                continue
            out.append(self.finding(
                mod, node,
                f"torch.{fn}() without dtype= in the fleet backend takes "
                "torch's float32 default — pass dtype= (float64 for the "
                "backend's floats) so results match the float64 numpy "
                "reference"))
        return out
