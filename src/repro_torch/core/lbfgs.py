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
from repro_torch.kernels import ref as kernel_ref
from repro_torch.obs import NULL_TRACER
from repro_torch.utils.pytree import tree_leaves, tree_map
from repro_torch.utils.sharding import LeafSum


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


def push_(h: History, s, y, ok: torch.Tensor) -> History:
    """``where(ok, push(h, s, y), h)`` bit for bit, written in place: only
    slot ``idx`` of each s and y leaf is written (its old pair kept where
    the 0-d bool ``ok`` is false), so the history is never copied (the
    counterpart of the reference's donated, aliased update); idx and count
    move only under ``ok``.  The returned History holds ``h``'s buffers."""
    slot = h.idx.long().reshape(1)
    m = tree_leaves(h.s)[0].shape[0]

    def write(b, v):
        b.index_copy_(0, slot, torch.where(ok, v.to(b.dtype).unsqueeze(0),
                                           b.index_select(0, slot)))

    tree_map(write, h.s, s)
    tree_map(write, h.y, y)
    return History(
        s=h.s, y=h.y,
        idx=torch.where(ok, (h.idx + 1) % m, h.idx),
        count=torch.where(ok, torch.clamp_max(h.count + 1, m), h.count),
    )


# ---------------------------------------------------------------------------
# Gram matrix
# ---------------------------------------------------------------------------
def gram_matrix(h: History, g) -> torch.Tensor:
    """M[i,j] = <b_i, b_j> for b = [s_0.., y_0.., g]; f32 accumulation,
    one leaf and one column block at a time (``gram``'s plain path: CPU
    tensors and kernels="off"; no f32 copy of a whole bf16 history
    leaf)."""
    return kernel_ref.vlbfgs_gram_leaves_ref(
        tree_leaves(h.s), tree_leaves(h.y), tree_leaves(g))


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
    # e_g made on the device: an item assignment (`delta[2 * m] = 1.0`)
    # copies its scalar from pageable host memory, which waits for the
    # device's queue
    delta = (torch.arange(n, device=dev) == 2 * m).to(torch.float32)

    def slot(age):  # age 0 = newest
        return torch.remainder(idx - 1 - age, m)

    # entries and rows at 0-d device indices, gathered as 1-element
    # indices (a 0-d index would read its value on the host)
    def row(i):
        return M.index_select(0, i.reshape(1))[0]

    def entry(i, j):
        return row(i).index_select(0, j.reshape(1))[0]

    def rho_of(i):
        sy = entry(i, m + i)
        return torch.where(torch.abs(sy) > 1e-20, 1.0 / sy, zero)

    alphas = []
    for age in range(m):
        i = slot(age)
        rho = rho_of(i) * (age < count).float()
        alpha = rho * torch.dot(row(i), delta)        # <s_i, q>
        delta = delta.index_add(0, (m + i).reshape(1), -alpha.reshape(1))
        alphas.append(alpha)
    alphas = torch.stack(alphas)

    newest = slot(0)
    sy = entry(newest, m + newest)
    yy = entry(m + newest, m + newest)
    gamma = torch.where((count > 0) & (yy > 1e-20), sy / yy,
                        torch.ones((), dtype=torch.float32, device=dev))
    delta = delta * gamma

    for k in range(m):
        age = count - 1 - k  # oldest first among live entries
        i = slot(age)
        live = (age >= 0) & (age < count)
        rho = rho_of(i) * live.float()
        beta = rho * torch.dot(row(m + i), delta)     # <y_i, r>
        alpha = torch.where(live, alphas.index_select(
            0, age.clamp(0, m - 1).reshape(1))[0], zero)
        delta = delta.index_add(0, i.reshape(1), (alpha - beta).reshape(1))
    return delta


def combine(h: History, g, delta: torch.Tensor):
    """p = -(Σ_i δ_i s_i + Σ_i δ_{m+i} y_i + δ_{2m} g): local O(d).

    f32 accumulation without an f32 copy of an (m, ...) history leaf, as
    the reference's ``preferred_element_type`` einsum: an f32 leaf
    contracts over m in one product; any other (a bf16 history) sums into
    one f32 buffer slot by slot."""
    m = tree_leaves(h.s)[0].shape[0]
    ds, dy, dg = delta[:m], delta[m:2 * m], delta[2 * m]

    def leaf(sb, yb, gl):
        if sb.dtype == yb.dtype == torch.float32:
            acc = torch.tensordot(ds, sb, dims=1)
            acc = acc + torch.tensordot(dy, yb, dims=1)
        else:
            acc = torch.zeros(gl.shape, dtype=torch.float32, device=gl.device)
            for i in range(m):
                acc.addcmul_(sb[i], ds[i])
            for i in range(m):
                acc.addcmul_(yb[i], dy[i])
        acc = acc + dg * gl.float()
        return (-acc).to(gl.dtype)

    return tree_map(leaf, h.s, h.y, g)


def gram(h: History, g, kernels: str = "off", leaf_sum=None) -> torch.Tensor:
    """The server step's Gram matrix, ``kernels`` ("auto" | "on" | "off")
    sending it through the hand-written kernel for CUDA tensors, which
    reads the basis [s_0.., y_0.., g] in place from the history's (m, ...)
    leaves and g's leaves, each group in its own dtype (a bf16 history is
    read as it is: no f32 copy); the plain path is ``gram_matrix``'s.  The
    reference concatenates the (2m+1, D) f32 basis first, for one Pallas
    call.

    ``leaf_sum`` (``utils.sharding.LeafSum``, ``LeafSum.local(g)`` when
    None): ``h`` and ``g`` are this rank's shards of a history laid out on
    a mesh, and the Gram is summed from the local shards and reduced by one
    all-reduce (``kernels.ops.vlbfgs_gram_leaves_sharded``).  A history
    held whole is its one-group case: one kernel launch, no all-reduce."""
    if leaf_sum is None:
        leaf_sum = LeafSum.local(g)
    return kernel_ops.vlbfgs_gram_leaves_sharded(
        *([leaf.contiguous() for leaf in tree_leaves(t)]
          for t in (h.s, h.y, g)), leaf_sum, mode=kernels)


def direction(h: History, g, kernels: str = "off", leaf_sum=None,
              tracer=NULL_TRACER):
    """Full VL-BFGS step: p = -H_t g (Alg. 1 line 6).

    The Gram matrix is ``gram(h, g, kernels, leaf_sum)``; the two loops
    and the combination run on it (replicated on every rank of a mesh)
    and on the local shards, with no communication.  ``tracer`` marks the
    three as the spans ``server.gram`` (its all-reduce included on a mesh),
    ``server.two_loop`` and ``server.combine`` of ``tracer.step``."""
    m = tree_leaves(h.s)[0].shape[0]
    step = tracer.step
    with tracer.wall_span("server.gram", round_id=step):
        M = gram(h, g, kernels, leaf_sum)
    with tracer.wall_span("server.two_loop", round_id=step):
        delta = direction_coeffs(M, h.idx, h.count, m)
    with tracer.wall_span("server.combine", round_id=step):
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
