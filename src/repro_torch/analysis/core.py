"""The lint engine of ``repro_torch.analysis`` (a copy of
``repro.analysis.core``, kept apart so that the port imports nothing of
the reference package): source loading, the ``Rule`` protocol + registry,
pragma suppression, baselines, and the runner.

Everything here is **pure stdlib + pure AST**: the analyzer must never
import the modules it lints (no torch, no numpy), so it runs in seconds
on a bare Python install.  Rules register themselves mirroring
the strategy / codec / policy registries::

    @register
    class MyRule(Rule):
        id = "RPL099"
        title = "my-contract"
        description = "one line for --list-rules / reports"

        def check(self, mod):
            return [self.finding(mod, node, "message") for node in ...]

Suppression layers, innermost first:

  * pragma — ``# repro: allow[RPL001]`` on the finding's line (or on a
    comment-only line directly above it) suppresses the named rules;
    ``allow[*]`` suppresses every rule.  Pragmas are the documented
    opt-in for sites that *intend* to break a contract (CAT_WALL
    tracing, seeded-RNG shims).
  * baseline — a committed JSON file of grandfathered finding
    fingerprints (rule + path + line-content hash, count-aware so
    moved lines don't churn).  New findings never match old
    fingerprints; fixing a finding leaves a stale entry that
    ``--write-baseline`` garbage-collects.
"""
from __future__ import annotations

import abc
import ast
import hashlib
import io
import json
import os
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

PRAGMA_PREFIX = "repro:"
PRAGMA_ALLOW = "allow["
BASELINE_DEFAULT = "analysis-baseline-torch.json"
_SKIP_DIRS = {".git", "__pycache__", ".ruff_cache", ".mypy_cache",
              ".pytest_cache", "node_modules", ".venv", "venv"}


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str          # posix-style path as given on the command line
    line: int          # 1-based
    col: int           # 0-based, ast convention
    message: str
    snippet: str = ""  # the stripped source line, for fingerprints/reports

    def fingerprint(self) -> str:
        """Line-number-free identity: rule + path + content hash, so a
        baselined finding survives unrelated edits above it."""
        h = hashlib.sha1(self.snippet.strip().encode()).hexdigest()[:12]
        return f"{self.rule}:{self.path}:{h}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1} {self.rule} {self.message}"

    def as_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet,
                "fingerprint": self.fingerprint()}


# ---------------------------------------------------------------------------
# Parsed module + shared AST helpers
# ---------------------------------------------------------------------------
class ModuleSource:
    """One parsed file plus the derived indexes every rule wants:
    parent links, dotted-name resolution, import origins, and the
    pragma table."""

    def __init__(self, path: str, text: str):
        self.path = path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.imports = self._import_map()
        self.pragmas = self._pragma_map()

    @classmethod
    def load(cls, path: str) -> "ModuleSource":
        with open(path, encoding="utf-8") as f:
            return cls(path, f.read())

    # -- structure -------------------------------------------------------
    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        while node in self.parents:
            node = self.parents[node]
            yield node

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def at_module_level(self, node: ast.AST) -> bool:
        """No enclosing function or class body (plain module statements,
        possibly nested in module-level if/try blocks)."""
        return not any(isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Lambda))
                       for a in self.ancestors(node))

    def dotted(self, node: ast.AST) -> Optional[str]:
        """``a.b.c`` for a Name/Attribute chain rooted at a Name, else
        None (calls/subscripts in the chain break resolution)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return None

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Like :meth:`dotted`, with the first segment expanded through
        the module's imports — ``cuda.matmul`` under ``from torch.backends
        import cuda`` resolves to ``torch.backends.cuda.matmul``."""
        d = self.dotted(node)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        origin = self.imports.get(head)
        if origin is None:
            return d
        return f"{origin}.{rest}" if rest else origin

    def _import_map(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    if a.name == "*":
                        continue
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    # -- pragmas ---------------------------------------------------------
    def _pragma_map(self) -> dict[int, frozenset]:
        """{line: rules allowed there}; a pragma on a comment-only line
        also covers the next line (for calls too long to share a line)."""
        out: dict[int, set] = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except tokenize.TokenError:
            return {}
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            rules = parse_pragma(tok.string)
            if rules is None:
                continue
            line = tok.start[0]
            out.setdefault(line, set()).update(rules)
            code = self.lines[line - 1][:tok.start[1]].strip()
            if not code:  # comment-only line: cover the line below too
                out.setdefault(line + 1, set()).update(rules)
        return {k: frozenset(v) for k, v in out.items()}

    def suppressed(self, finding: Finding) -> bool:
        rules = self.pragmas.get(finding.line)
        return bool(rules) and ("*" in rules or finding.rule in rules)


def parse_pragma(comment: str) -> Optional[set]:
    """``# repro: allow[RPL001,RPL005]`` -> {"RPL001", "RPL005"};
    ``allow[*]`` -> {"*"}; non-pragma comments -> None."""
    body = comment.lstrip("#").strip()
    if not body.startswith(PRAGMA_PREFIX):
        return None
    body = body[len(PRAGMA_PREFIX):].strip()
    if not body.startswith(PRAGMA_ALLOW) or "]" not in body:
        return None
    inner = body[len(PRAGMA_ALLOW):body.index("]")]
    return {r.strip() for r in inner.split(",") if r.strip()}


def contains_name(node: ast.AST, names: set) -> bool:
    """True if any Name in ``node``'s subtree is in ``names``."""
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


# ---------------------------------------------------------------------------
# Rule protocol + registry (mirrors strategies / codecs / policies)
# ---------------------------------------------------------------------------
class Rule(abc.ABC):
    """One static contract.  Subclass, set ``id``/``title``/
    ``description``, implement ``check``, and decorate with
    :func:`register`."""

    id: str = ""
    title: str = ""
    description: str = ""

    def applies_to(self, path: str) -> bool:
        """Path filter (posix-style path); default: every file."""
        return True

    @abc.abstractmethod
    def check(self, mod: ModuleSource) -> list:
        """-> [Finding] for one parsed module."""

    def finding(self, mod: ModuleSource, node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        snippet = mod.lines[line - 1].strip() if line <= len(mod.lines) else ""
        return Finding(self.id, mod.path, line,
                       getattr(node, "col_offset", 0), message, snippet)


_REGISTRY: dict[str, type] = {}


def register(cls: type) -> type:
    """Class decorator: add a :class:`Rule` subclass to the registry."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} must set a non-empty id")
    _REGISTRY[cls.id] = cls
    return cls


def get(rule_id: str) -> type:
    if rule_id not in _REGISTRY:
        raise ValueError(f"unknown rule {rule_id!r}; known: {names()}")
    return _REGISTRY[rule_id]


def names() -> list:
    return sorted(_REGISTRY)


def all_rules() -> list:
    """Fresh instances of every registered rule, id-sorted."""
    return [_REGISTRY[i]() for i in names()]


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------
@dataclass
class Baseline:
    """Grandfathered finding fingerprints with per-fingerprint counts
    (two identical lines in one file share a fingerprint)."""
    counts: dict = field(default_factory=dict)
    path: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls(path=path)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return cls(counts=dict(data.get("findings", {})), path=path)

    @classmethod
    def from_findings(cls, findings: Iterable[Finding],
                      path: Optional[str] = None) -> "Baseline":
        counts: dict = {}
        for f in findings:
            fp = f.fingerprint()
            counts[fp] = counts.get(fp, 0) + 1
        return cls(counts=counts, path=path)

    def write(self, path: Optional[str] = None) -> str:
        path = path or self.path or BASELINE_DEFAULT
        payload = {"version": 1,
                   "comment": "grandfathered repro_torch.analysis findings; "
                              "regenerate with --write-baseline",
                   "findings": dict(sorted(self.counts.items()))}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def filter(self, findings: list) -> tuple:
        """-> (new findings, baselined count).  Consumes up to
        ``counts[fp]`` occurrences of each fingerprint."""
        budget = dict(self.counts)
        fresh, eaten = [], 0
        for f in findings:
            fp = f.fingerprint()
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                eaten += 1
            else:
                fresh.append(f)
        return fresh, eaten


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------
def iter_py_files(paths: Iterable[str]) -> list:
    out = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                       if f.endswith(".py"))
    return out


def check_module(mod: ModuleSource,
                 rules: Optional[list] = None) -> list:
    """All (pragma-filtered) findings for one parsed module."""
    findings = []
    for rule in (rules if rules is not None else all_rules()):
        if not rule.applies_to(mod.path):
            continue
        findings.extend(f for f in rule.check(mod)
                        if not mod.suppressed(f))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def run_paths(paths: Iterable[str], rules: Optional[list] = None,
              on_error: Optional[Callable] = None) -> list:
    """Lint every .py under ``paths``.  Unparseable files become
    synthetic ``PARSE`` findings (a lint gate must not skip code it
    cannot read)."""
    findings = []
    for path in iter_py_files(paths):
        try:
            mod = ModuleSource.load(path)
        except (SyntaxError, UnicodeDecodeError) as e:
            line = getattr(e, "lineno", 1) or 1
            findings.append(Finding("PARSE", path.replace(os.sep, "/"),
                                    line, 0, f"could not parse: {e}"))
            if on_error is not None:
                on_error(path, e)
            continue
        findings.extend(check_module(mod, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
