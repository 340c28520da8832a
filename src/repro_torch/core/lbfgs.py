"""Vector-free L-BFGS (paper Sec. IV-A; two-loop recursion of [44]).

Port of ``repro.core.lbfgs``: the direction is expressed in the basis
b = [s_0..s_{m-1}, y_0..y_{m-1}, g] and the two loops run on the
(2m+1)x(2m+1) Gram matrix of that basis.  History is a circular buffer
(leaves with a leading ``m`` dim, a write index and a live count).

The index, count and curvature flag stay 0-d device tensors and every
branch on them is a ``torch.where``, as in the reference, so a server step
never waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils.pytree import tree_leaves, tree_map


class History(NamedTuple):
    s: object              # tree, leaves (m, ...) — parameter deltas
    y: object              # tree, leaves (m, ...) — FIM-smoothed grad deltas
    idx: torch.Tensor      # () int32 — next write slot
    count: torch.Tensor    # () int32 — number of live pairs (<= m)


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def init(params, m: int, dtype=None) -> History:
    def alloc(p):
        return torch.zeros((m,) + tuple(p.shape), dtype=dtype or p.dtype,
                           device=p.device)

    dev = _device(params)
    return History(
        s=tree_map(alloc, params),
        y=tree_map(alloc, params),
        idx=torch.zeros((), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def push(h: History, s, y) -> History:
    slot = h.idx.long().reshape(1)

    def write(b, v):
        return b.index_copy(0, slot, v.to(b.dtype).unsqueeze(0))

    m = tree_leaves(h.s)[0].shape[0]
    return History(
        s=tree_map(write, h.s, s), y=tree_map(write, h.y, y),
        idx=(h.idx + 1) % m,
        count=torch.clamp_max(h.count + 1, m),
    )


# ---------------------------------------------------------------------------
# Gram matrix
# ---------------------------------------------------------------------------
def gram_matrix(h: History, g) -> torch.Tensor:
    """M[i,j] = <b_i, b_j> for b = [s_0.., y_0.., g]; f32 accumulation,
    one leaf at a time (the plain path: CPU tensors and kernels="off")."""
    m = tree_leaves(h.s)[0].shape[0]
    n = 2 * m + 1
    M = torch.zeros((n, n), dtype=torch.float32, device=_device(g))
    for sb, yb, gl in zip(tree_leaves(h.s), tree_leaves(h.y), tree_leaves(g),
                          strict=True):
        rows = torch.cat([sb.reshape(m, -1).float(), yb.reshape(m, -1).float(),
                          gl.reshape(1, -1).float()], dim=0)
        M = M + rows @ rows.T
    return M


# ---------------------------------------------------------------------------
# Two-loop recursion in Gram space
# ---------------------------------------------------------------------------
def direction_coeffs(M: torch.Tensor, idx: torch.Tensor, count: torch.Tensor,
                     m: int) -> torch.Tensor:
    """Coefficients δ with  H·g = Σ_j δ_j b_j  (so the step is p = -Σ δ b).

    Slots are visited newest-to-oldest in the first loop and
    oldest-to-newest in the second, honouring the circular buffer.  Empty
    slots contribute nothing (ρ=0), so with count==0 this degrades to
    δ = e_g (steepest descent)."""
    n = 2 * m + 1
    dev = M.device
    idx = idx.long()
    count = count.long()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    delta = torch.zeros((n,), dtype=torch.float32, device=dev)
    delta[2 * m] = 1.0

    def slot(age):  # age 0 = newest
        return torch.remainder(idx - 1 - age, m)

    def rho_of(i):
        sy = M[i, m + i]
        return torch.where(torch.abs(sy) > 1e-20, 1.0 / sy, zero)

    alphas = []
    for age in range(m):
        i = slot(age)
        rho = rho_of(i) * (age < count).float()
        alpha = rho * torch.dot(M[i], delta)          # <s_i, q>
        delta = delta.index_add(0, (m + i).reshape(1), -alpha.reshape(1))
        alphas.append(alpha)
    alphas = torch.stack(alphas)

    newest = slot(0)
    sy = M[newest, m + newest]
    yy = M[m + newest, m + newest]
    gamma = torch.where((count > 0) & (yy > 1e-20), sy / yy,
                        torch.ones((), dtype=torch.float32, device=dev))
    delta = delta * gamma

    for k in range(m):
        age = count - 1 - k  # oldest first among live entries
        i = slot(age)
        live = (age >= 0) & (age < count)
        rho = rho_of(i) * live.float()
        beta = rho * torch.dot(M[m + i], delta)       # <y_i, r>
        alpha = torch.where(live, alphas[age.clamp(0, m - 1)], zero)
        delta = delta.index_add(0, i.reshape(1), (alpha - beta).reshape(1))
    return delta


def combine(h: History, g, delta: torch.Tensor):
    """p = -(Σ_i δ_i s_i + Σ_i δ_{m+i} y_i + δ_{2m} g): local O(d)."""
    m = tree_leaves(h.s)[0].shape[0]
    ds, dy, dg = delta[:m], delta[m:2 * m], delta[2 * m]

    def leaf(sb, yb, gl):
        acc = torch.tensordot(ds, sb.float(), dims=1)
        acc = acc + torch.tensordot(dy, yb.float(), dims=1)
        acc = acc + dg * gl.float()
        return (-acc).to(gl.dtype)

    return tree_map(leaf, h.s, h.y, g)


def _gram_via_kernel(h: History, g, kernels: str) -> torch.Tensor:
    """Gram matrix through the hand-written kernel, which reads the basis
    [s_0.., y_0.., g] in place from the history's (m, ...) leaves and g's
    leaves in one launch (the reference concatenates the (2m+1, D) basis
    first, for one Pallas call)."""
    def f32(tree):
        return [leaf.float().contiguous() for leaf in tree_leaves(tree)]

    return kernel_ops.vlbfgs_gram_leaves(f32(h.s), f32(h.y), f32(g),
                                         mode=kernels)


def direction(h: History, g, kernels: str = "off"):
    """Full VL-BFGS step: p = -H_t g (Alg. 1 line 6).

    ``kernels`` ("auto" | "on" | "off") sends the Gram matrix through the
    CUDA kernel for CUDA tensors; the plain path is the per-leaf
    ``gram_matrix``."""
    m = tree_leaves(h.s)[0].shape[0]
    if kernel_ops.resolve(kernels, _device(g)) == "plain":
        M = gram_matrix(h, g)
    else:
        M = _gram_via_kernel(h, g, kernels)
    delta = direction_coeffs(M, h.idx, h.count, m)
    return combine(h, g, delta)


def reference_two_loop(s_list, y_list, g):
    """Textbook O(d)-vector two-loop recursion (oracle for tests).

    s_list/y_list: python lists of flat f64 arrays, oldest first."""
    q = np.asarray(g, dtype=np.float64).copy()
    alphas = []
    rhos = [1.0 / float(np.dot(y, s))
            for s, y in zip(s_list, y_list, strict=True)]
    for s, y, rho in zip(reversed(s_list), reversed(y_list), reversed(rhos),
                         strict=True):
        a = rho * float(np.dot(s, q))
        q -= a * np.asarray(y, np.float64)
        alphas.append(a)
    if s_list:
        gamma = float(np.dot(s_list[-1], y_list[-1])
                      / np.dot(y_list[-1], y_list[-1]))
    else:
        gamma = 1.0
    r = gamma * q
    for (s, y, rho), a in zip(zip(s_list, y_list, rhos, strict=True),
                              reversed(alphas), strict=True):
        b = rho * float(np.dot(y, r))
        r += (a - b) * np.asarray(s, np.float64)
    return -r
