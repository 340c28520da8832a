"""Plain reference of Algorithm 1's server step (arXiv:2110.07567, Alg. 1
lines 5-9): the Fisher diagonal's EMA, the textbook L-BFGS two-loop
recursion over the stored (s, y) pairs in float64, the trust-region clip
on the step, and the FIM-smoothed pair y = (Gamma + lambda I) s pushed
under the curvature test.  Imports nothing of the program.

The pairs are kept in the history's stated dtype (float32, or bfloat16
for the LLM configuration) and the parameters in theirs, as the
configuration states; everything else is computed in float32 or wider.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


@dataclass
class Knobs:
    learning_rate: float
    m: int = 10
    damping: float = 1e-2
    rel_damping: float = 0.1
    fim_ema: float = 0.95
    curvature_eps: float = 1e-8
    max_step_norm: float = 1.0
    history_dtype: torch.dtype = torch.float32


def dot(a: list, b: list) -> float:
    """<a, b> over every leaf, in float64."""
    return float(sum(torch.dot(x.reshape(-1).double(), y.reshape(-1).double())
                     for x, y in zip(a, b, strict=True)))


@dataclass
class Server:
    params: list                     # leaves, in the parameters' dtype
    knobs: Knobs
    diag: list | None = None         # Fisher EMA, float32
    pairs: list = field(default_factory=list)   # (s, y) leaves, oldest first
    steps: int = 0
    ring_fault: bool = False         # planted: a full history drops its newest pair

    def step(self, grad: list, fisher: list, alter=None) -> list:
        """One server round on the aggregated (g, Gamma); -> the step s as
        the history holds it.  ``alter(s)``, where given, edits the step in
        place before it is applied (a planted fault)."""
        k = self.knobs
        if self.diag is None:
            self.diag = [f.float().clone() for f in fisher]
        else:
            self.diag = [k.fim_ema * d + (1.0 - k.fim_ema) * f.float()
                         for d, f in zip(self.diag, fisher, strict=True)]
        # two-loop recursion: p = -H g, in float64, updated in place
        r = [g.double() for g in grad]
        alphas = []
        for s, y in reversed(self.pairs):
            sy = dot(s, y)
            rho = 1.0 / sy if abs(sy) > 1e-20 else 0.0
            a = rho * dot(s, r)
            for ri, yi in zip(r, y, strict=True):
                ri.sub_(yi.double(), alpha=a)
            alphas.append(a)
        gamma = 1.0
        if self.pairs:
            s, y = self.pairs[-1]
            yy = dot(y, y)
            if yy > 1e-20:
                gamma = dot(s, y) / yy
        for ri in r:
            ri.mul_(gamma)
        for (s, y), a in zip(self.pairs, reversed(alphas), strict=True):
            sy = dot(s, y)
            rho = 1.0 / sy if abs(sy) > 1e-20 else 0.0
            b = rho * dot(y, r)
            for ri, si in zip(r, s, strict=True):
                ri.add_(si.double(), alpha=a - b)
        pn = math.sqrt(dot(r, r))
        scale = 1.0
        if k.max_step_norm:
            scale = min(1.0, k.max_step_norm / max(k.learning_rate * pn, 1e-12))
        s_new = [(-k.learning_rate * scale * ri).float() for ri in r]
        del r
        if alter is not None:
            alter(s_new)
        self.params = [(p.float() + s).to(p.dtype)
                       for p, s in zip(self.params, s_new, strict=True)]
        numel = sum(d.numel() for d in self.diag)
        lam = k.damping + k.rel_damping * sum(float(d.double().sum())
                                              for d in self.diag) / numel
        y_new = [(d + lam) * s for d, s in zip(self.diag, s_new, strict=True)]
        sy, ss, yy = dot(s_new, y_new), dot(s_new, s_new), dot(y_new, y_new)
        if sy > k.curvature_eps * math.sqrt(ss) * math.sqrt(yy):
            pair = ([s.to(k.history_dtype) for s in s_new],
                    [y.to(k.history_dtype) for y in y_new])
            if self.ring_fault and len(self.pairs) == k.m:
                self.pairs[-1] = pair
            else:
                self.pairs = (self.pairs + [pair])[-k.m:]
        self.steps += 1
        return [s.to(k.history_dtype) for s in s_new]


def leaf_norms(leaves: list) -> list[float]:
    return [float(torch.linalg.vector_norm(x.detach().double())) for x in leaves]
