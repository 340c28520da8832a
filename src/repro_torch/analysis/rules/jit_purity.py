"""RPL003 — jit-purity: no host syncs inside the port's device bodies.

The reference forbids host reads inside ``jax.jit`` functions; the
port has no tracer, but the same contract holds on the card: a device
body that reads a tensor's value on the host waits for the device (a
device->host sync) and serialises the queue behind it.

Scope: ``edge/fleet/kernel.py`` and ``src/repro_torch/kernels/`` (not
``ref.py``, the plain versions, nor ``_build.py``, the build).  The
*device bodies*, the counterpart of the reference's jit-decorated
functions, are:

  * in the fleet kernel, the module's private functions (``_need``,
    ``_bw_widths``, ...): the public ``*_jit`` wrappers read their
    result back once by design, as the reference reads back outside
    ``jax.jit``;
  * in ``kernels/``, every module-level function (the launch wrappers,
    ``ops.py``'s dispatchers and their helpers).

*Tensors*, the counterpart of traced values, are the body's parameters
(and those of functions nested in it) except those annotated ``int``,
``float``, ``bool`` or ``str`` — the annotation plays the part of
``static_argnames`` — or ``torch.device``/``torch.dtype``/
``torch.Generator``, which hold no tensor data, or a container or
union of these (``list[int]``, ``str | None``).  A parameter annotated
as a container of tensors (``list[torch.Tensor]``) holds tensors in its
elements; its own truthiness and length are host values.  Inside a
device body the rule flags:

  * ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and
    ``torch.cuda.synchronize()``;
  * ``float()``/``int()``/``bool()``/``complex()``/``np.*`` applied to
    a tensor's value;
  * a Python ``if``/``while``/``assert``/ternary whose test reads a
    tensor's value;
  * a subscript indexed by a full reduction (``torch.argmax``/
    ``argmin``/``max``/``min``/``sum`` without ``dim``, or ``.argmax()``
    and kin with no arguments): indexing with a 0-d tensor reads its
    value on the host (``aten._local_scalar_dense``).

A tensor read only through its metadata (``.shape``, ``.dtype``,
``.device``, ``.is_cuda``, ``.ndim``, ``.requires_grad``, ``.dim()``,
``.numel()``, ``.size()``, ``.stride()``, ``.is_contiguous()``,
``.data_ptr()``, ``len()``, ``isinstance()``, ``is None``) is not read
on the device.  Values derived through assignments are not chased, as
in the reference.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.core import ModuleSource, Rule, register

HOST_CASTS = {"float", "bool", "int", "complex"}
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNC_CALLS = {"torch.cuda.synchronize"}
# annotations of parameters that hold no tensor data
SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "torch.device",
                      "torch.dtype", "torch.Generator"}
CONTAINERS = {"list", "tuple", "List", "Tuple", "Sequence", "Iterable"}
UNIONS = {"Optional", "Union"}
META_ATTRS = {"shape", "dtype", "device", "is_cuda", "ndim",
              "requires_grad"}
META_METHODS = {"dim", "numel", "size", "stride", "is_contiguous",
                "data_ptr"}
META_CALLS = {"len", "isinstance"}
FULL_REDUCTIONS = {"argmax", "argmin", "max", "min", "sum"}
KERNEL_FILES_EXCLUDED = ("kernels/ref.py", "kernels/_build.py")


def _kind(mod: ModuleSource, ann) -> str:
    """"scalar" | "container" | "tensor" for a parameter's annotation:
    no annotation is a tensor; a container (``list``, ``tuple``,
    ``Sequence``, ...) of scalars is a scalar; a union is its widest
    member."""
    if ann is None:
        return "tensor"
    if isinstance(ann, ast.Constant):
        if isinstance(ann.value, str):
            return _kind(mod, ast.parse(ann.value, mode="eval").body)
        return "scalar"                  # None, and tuple[int, ...]'s ...
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _widest(_kind(mod, ann.left), _kind(mod, ann.right))
    name = mod.resolve(ann.value if isinstance(ann, ast.Subscript)
                       else ann) or ""
    last = name.rsplit(".", 1)[-1]
    if last in CONTAINERS or last in UNIONS:
        args = []
        if isinstance(ann, ast.Subscript):
            index = ann.slice
            args = index.elts if isinstance(index, ast.Tuple) else [index]
        kinds = [_kind(mod, a) for a in args]
        widest = "scalar" if not kinds else _widest(*kinds)
        if last in UNIONS or widest == "scalar":
            return widest
        return "container"
    return "scalar" if name in SCALAR_ANNOTATIONS else "tensor"


def _widest(*kinds: str) -> str:
    for k in ("tensor", "container"):
        if k in kinds:
            return k
    return "scalar"


def _params(mod: ModuleSource, fn, kind: str) -> set:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if _kind(mod, p.annotation) == kind}


def _via_metadata(mod: ModuleSource, node: ast.AST) -> bool:
    """Does this use of a tensor read only its metadata?"""
    child = node
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Subscript) and anc.value is child:
            child = anc
        elif isinstance(anc, ast.Attribute) and anc.value is child:
            if anc.attr in META_ATTRS:
                return True
            if anc.attr in META_METHODS:
                call = mod.parents.get(anc)
                return isinstance(call, ast.Call) and call.func is anc
            return False
        elif isinstance(anc, ast.Compare):
            return all(isinstance(op, (ast.Is, ast.IsNot)) for op in anc.ops)
        elif isinstance(anc, ast.Call):
            return mod.resolve(anc.func) in META_CALLS and child in anc.args
        else:
            return False
    return False


def reads_value(mod: ModuleSource, node: ast.AST, tensors: set,
                containers: set) -> bool:
    """True if ``node``'s subtree reads a tensor's value other than
    through its metadata: a tensor name, or an element of a container of
    tensors (the container's own truthiness and length are host
    values)."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Name):
            continue
        if n.id in tensors and not _via_metadata(mod, n):
            return True
        if n.id in containers:
            sub = mod.parents.get(n)
            if isinstance(sub, ast.Subscript) and sub.value is n \
                    and not _via_metadata(mod, sub):
                return True
    return False


def _is_full_reduction(mod: ModuleSource, node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = mod.resolve(node.func) or ""
    head, _, fn = d.partition(".")
    if head == "torch" and fn in FULL_REDUCTIONS:
        return len(node.args) == 1 and not any(
            kw.arg in ("dim", None) for kw in node.keywords)
    return isinstance(node.func, ast.Attribute) \
        and node.func.attr in FULL_REDUCTIONS \
        and not node.args and not node.keywords


@register
class JitPurityRule(Rule):
    id = "RPL003"
    title = "jit-purity"
    description = ("no .item()/.cpu()/float()/torch.cuda.synchronize() "
                   "host syncs, Python branching on tensor values, or "
                   "0-d-reduction indexing inside the device bodies "
                   "(fleet kernel + repro_torch.kernels)")

    def applies_to(self, path: str) -> bool:
        if any(path.endswith(x) for x in KERNEL_FILES_EXCLUDED):
            return False
        return "edge/fleet/kernel" in path or "repro_torch/kernels/" in path

    def check(self, mod: ModuleSource) -> list:
        fleet = "edge/fleet/kernel" in mod.path
        out = []
        for fn in mod.tree.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fleet and not fn.name.startswith("_"):
                continue
            tensors, containers = set(), set()
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)):
                    tensors |= _params(mod, sub, "tensor")
                    containers |= _params(mod, sub, "container")
            out.extend(self._check_body(mod, fn, tensors, containers))
        return out

    def _check_body(self, mod: ModuleSource, fn, tensors: set,
                    containers: set) -> list:
        out = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if reads_value(mod, node.test, tensors, containers):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "ternary", ast.Assert: "assert"}[
                                type(node)]
                    out.append(self.finding(
                        mod, node,
                        f"Python {kind} on a tensor's value inside device "
                        f"body {fn.name}() waits for the device — choose "
                        "on the device with torch.where"))
            elif isinstance(node, ast.Call):
                out.extend(self._check_call(mod, fn, node, tensors,
                                            containers))
            elif isinstance(node, ast.Subscript):
                index = node.slice
                parts = index.elts if isinstance(index, ast.Tuple) \
                    else [index]
                if any(_is_full_reduction(mod, p) for p in parts):
                    out.append(self.finding(
                        mod, node,
                        f"indexing by a 0-d reduction inside device body "
                        f"{fn.name}() reads the index on the host "
                        "(_local_scalar_dense) — select with "
                        "torch.index_select/gather on a 1-element index"))
        return out

    def _check_call(self, mod: ModuleSource, fn, node: ast.Call,
                    tensors: set, containers: set) -> list:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_METHODS:
            return [self.finding(
                mod, node,
                f".{node.func.attr}() inside device body {fn.name}() is a "
                "device->host sync — return the tensor and read it back "
                "once, outside the device body")]
        d = mod.resolve(node.func)
        if d is None:
            return []
        if d in SYNC_CALLS:
            return [self.finding(
                mod, node,
                f"{d}() inside device body {fn.name}() waits for the "
                "device — leave synchronisation to the caller")]
        hit = d in HOST_CASTS or d.startswith(("np.", "numpy."))
        if hit and any(reads_value(mod, a, tensors, containers)
                       for a in node.args):
            return [self.finding(
                mod, node,
                f"{d}() on a tensor's value inside device body "
                f"{fn.name}() reads it on the host — keep it a tensor "
                "(cast with .to(dtype))")]
        return []
