"""Mixture-of-Experts FFN with top-k routing and capacity-factor dispatch
(port of ``repro.models.moe``: its dense scatter/gather dispatch,
``_moe_apply_gspmd``).

Tokens are processed in groups of ``cfg.moe_group`` (halved until it
divides the token count); within a group each (token, pick) gets a slot in
its expert's capacity buffer by a token-major cumulative sum (the
GShard/Switch construction), materialised by scatter and gather on a
``(G, E, C+1, d)`` buffer whose overflow row C is sliced off.  Picks past
an expert's capacity are dropped (capacity-factor semantics), at decode
too, where a group is the batch; the Switch load-balance loss keeps the
router near uniform.

The body is split into the steps a test (or ``chip_smoke.py``, which wraps
``route`` and ``assign_slots`` to record the routing) can reach: ``route``
-> ``assign_slots`` -> ``dispatch`` -> ``expert_ffn`` -> ``combine``.

On a mesh (``layers.use_mesh``, DTensor activations) the MoE runs the
reference's expert-parallel path (``moe_apply_expert_parallel``): a
``local_map`` over the model axis, the counterpart of its ``shard_map``.
Each rank routes its local tokens over all E experts, runs only its
E / model experts, and the combine is one token-sized sum over the model
axis (the reference's ``psum``, not an all-to-all); aux and the dropped
share are then averaged over the batch axes.  Where the reference's gate
sends it to the dense dispatch instead (few tokens: decode), every rank
routes all the tokens, as that dispatch's global groups need.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import dense_init
from repro_torch.utils import sharding as shd


def moe_init(generator: torch.Generator, cfg, stack: int | None = None) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = (stack,) if stack else ()
    dtype = cfg.activation_dtype
    return {
        # the router stays f32 (the reference's): routing decisions are
        # taken in f32 whatever the activation dtype
        "router": dense_init(generator, lead + (d, E), torch.float32),
        "wi": dense_init(generator, lead + (E, d, ff), dtype),
        "wg": dense_init(generator, lead + (E, d, ff), dtype),
        "wo": dense_init(generator, lead + (E, ff, d), dtype),
    }


def moe_axes(stack: int | None = None) -> dict:
    """The logical axes of ``moe_init``'s tree; the router is replicated
    ("router_experts"): every expert shard takes the same routing
    decisions locally (the expert-parallel path relies on it)."""
    pre = "layers," if stack else ""
    return {"router": pre + "embed,router_experts",
            "wi": pre + "experts,embed,expert_mlp",
            "wg": pre + "experts,embed,expert_mlp",
            "wo": pre + "experts,expert_mlp,embed"}


def _capacity(group: int, top_k: int, num_experts: int, factor: float) -> int:
    c = math.ceil(top_k * group / num_experts * factor)
    return max(8, -(-c // 8) * 8) if group >= 64 else max(1, c)


def group_size(n_tokens: int, moe_group: int) -> int:
    """Tokens a dispatch group: ``moe_group``, halved until it divides the
    token count."""
    group = min(moe_group, n_tokens)
    while n_tokens % group:
        group //= 2
    return group


def route(p, cfg, xg: torch.Tensor):
    """xg (G, T, d) -> (probs (G, T, E) f32, gates (G, T, k) f32 summing
    to 1 a token, expert_idx (G, T, k) int64): f32 router logits, softmax,
    top-k, the k gates renormalised."""
    logits = torch.einsum("gtd,de->gte", xg.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gates / gates.sum(dim=-1, keepdim=True), expert_idx


def assign_slots(expert_idx: torch.Tensor, num_experts: int, capacity: int):
    """expert_idx (G, T, k) -> (slot, keep), each (G, T*k): each pick's
    position in its expert's queue, token-major (token t's picks before
    token t+1's), and whether it falls inside the capacity."""
    G, T, k = expert_idx.shape
    flat = F.one_hot(expert_idx.reshape(G, T * k), num_experts)   # (G,T*k,E)
    slot = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(dim=-1)
    return slot, slot < capacity


def _rows(expert_idx, slot, keep, capacity: int):
    """The (group, expert, slot) index triple of each pick, dropped picks
    sent to the overflow row ``capacity``."""
    G, T, k = expert_idx.shape
    g_idx = torch.arange(G, device=expert_idx.device)[:, None].expand(G, T * k)
    slot_c = torch.where(keep, slot, capacity)
    return g_idx, expert_idx.reshape(G, T * k), slot_c


def dispatch(xg, expert_idx, slot, keep, num_experts: int, capacity: int):
    """xg (G, T, d) -> the expert buffer (G, E, C, d): each kept pick's
    token in its (expert, slot) row.  Kept triples are unique, so each kept
    row is written once; only the overflow row C takes duplicates, and it
    is sliced off."""
    G, T, d = xg.shape
    k = expert_idx.shape[-1]
    x_rep = xg.repeat_interleave(k, dim=1)                        # (G,T*k,d)
    buf = xg.new_zeros((G, num_experts, capacity + 1, d))
    buf = torch.index_put(buf, _rows(expert_idx, slot, keep, capacity),
                          x_rep * keep[..., None].to(xg.dtype), accumulate=True)
    return buf[:, :, :capacity]


def expert_ffn(p, buf: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every (group, expert) buffer: (G, E, C, d) -> (G, E, C, d)."""
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"]) * F.silu(
        torch.einsum("gecd,edf->gecf", buf, p["wg"]))
    return torch.einsum("gecf,efd->gecd", h, p["wo"])


def combine(out_buf, expert_idx, slot, keep, gates) -> torch.Tensor:
    """Each pick's expert output, weighted by its gate (0 when dropped),
    summed over a token's k picks: -> (G, T, d)."""
    G, E, C, d = out_buf.shape
    T, k = expert_idx.shape[1:]
    out_buf = torch.cat([out_buf, out_buf.new_zeros((G, E, 1, d))], dim=2)
    tok = out_buf[_rows(expert_idx, slot, keep, C)]               # (G,T*k,d)
    tok = tok * (gates.reshape(G, T * k, 1) * keep[..., None]).to(tok.dtype)
    return tok.reshape(G, T, k, d).sum(dim=2)


def moe_apply(p, cfg, x: torch.Tensor):
    """x (B, S, d) -> (out (B, S, d), (aux_loss, dropped)): the Switch
    load-balance loss E * sum_e frac_e * mean_prob_e, and the share of
    picks dropped at capacity.

    On a mesh (DTensor ``x``) the experts are sharded over "model" and
    each rank runs only its own (``moe_apply_expert_parallel``): with the
    tokens sharded over the batch axes where the reference's gate holds
    (E divisible by the model axis, B by the batch shards, and at least 4
    dispatch groups of tokens: EP re-gathers FSDP expert weights every
    call, which a decode step's few tokens cannot amortise), else with
    every rank routing all the tokens (the dense dispatch's global
    groups, which a batch shard would cut across)."""
    mesh = layers.current_mesh()
    if mesh is not None and shd.is_dtensor(x):
        sizes = shd.mesh_shape(mesh)
        batch = math.prod(sizes.get(a, 1) for a in ("pod", "data"))
        shard_batch = (x.shape[0] % batch == 0
                       and x.shape[0] * x.shape[1] >= 4 * cfg.moe_group)
        return moe_apply_expert_parallel(p, cfg, x, mesh,
                                         shard_batch=shard_batch)
    B, S, d = x.shape
    T = group_size(B * S, cfg.moe_group)
    G = B * S // T
    E = cfg.num_experts
    C = _capacity(T, cfg.top_k, E, cfg.capacity_factor)
    xg = x.reshape(G, T, d)
    probs, gates, expert_idx = route(p, cfg, xg)
    slot, keep = assign_slots(expert_idx, E, C)
    buf = dispatch(xg, expert_idx, slot, keep, E, C)
    out = combine(expert_ffn(p, buf), expert_idx, slot, keep, gates)
    # Switch load-balance loss: fraction of tokens per expert x mean prob
    frac = F.one_hot(expert_idx, E).sum(dim=(0, 1, 2)).float() / (G * T)
    aux = E * torch.sum(frac * probs.mean(dim=(0, 1)))
    dropped = (~keep).float().mean()
    return out.reshape(B, S, d), (aux, dropped)


class _AllReduce(torch.autograd.Function):
    """``scale`` x the sum of a local tensor over a mesh dim, whose
    cotangent is the same on every rank of that dim (a replicated result):
    the backward scales it by ``scale`` and sends nothing."""

    @staticmethod
    def forward(ctx, x, mesh, dim: str, scale: float):
        import torch.distributed._functional_collectives as funcol

        ctx.scale = scale
        out = funcol.wait_tensor(funcol.all_reduce(x, "sum", mesh[dim]))
        return out * scale if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None


def _mean_over(x, mesh, dims):
    """The mean of ``x`` over the mesh dims ``dims`` (one at a time)."""
    sizes = shd.mesh_shape(mesh)
    for dim in dims:
        x = _AllReduce.apply(x, mesh, dim, 1.0 / sizes[dim])
    return x


def _local_moe(xl, router, wi, wg, wo, *, cfg, mesh, batch_axes,
               split: bool = True):
    """One rank's share of the expert-parallel MoE: its local tokens
    (B_local, S, d) routed over all E experts (the router is replicated,
    so every model rank takes the same decisions), only its E / model
    experts run (``wi``/``wg``/``wo`` hold them), each pick's slot taken
    in its expert's global queue, the outputs summed over the model
    axis."""
    Bl, S, d = xl.shape
    N = Bl * S
    T = group_size(N, cfg.moe_group)
    G = N // T
    E, k = cfg.num_experts, cfg.top_k
    E_local = wi.shape[0]
    e_off = mesh.get_local_rank("model") * E_local if split else 0
    C = _capacity(T, k, E, cfg.capacity_factor)
    xg = xl.reshape(G, T, d)
    probs, gates, idx = route({"router": router}, cfg, xg)
    slot, keep = assign_slots(idx, E, C)
    e_loc = idx - e_off
    mine = ((e_loc >= 0) & (e_loc < E_local)).reshape(G, T * k)
    e_loc = e_loc.clamp(0, E_local - 1)
    p_loc = {"wi": wi, "wg": wg, "wo": wo}
    buf = dispatch(xg, e_loc, slot, keep & mine, E_local, C)
    out = combine(expert_ffn(p_loc, buf), e_loc, slot, keep & mine, gates)
    # each rank contributed only its experts' outputs
    if split:
        out = _AllReduce.apply(out, mesh, "model", 1.0)
    frac = F.one_hot(idx, E).sum(dim=(0, 1, 2)).float() / (G * T)
    # every model rank computes the same aux: its mean over "model" is the
    # same value, and its backward sends each rank 1 / model of the
    # cotangent, so that the sum of the ranks' gradients counts it once
    aux = _mean_over(E * torch.sum(frac * probs.mean(dim=(0, 1))), mesh,
                     ["model"] if split else [])
    # the dropped share counts capacity overflows of LOCAL experts only;
    # the sum over the model axis reassembles the global count
    dropped = (mine & ~keep).float().sum()
    if split:
        dropped = _AllReduce.apply(dropped, mesh, "model", 1.0)
    dropped = dropped / (G * T * k)
    aux = _mean_over(aux, mesh, batch_axes)
    dropped = _mean_over(dropped, mesh, batch_axes)
    return out.reshape(Bl, S, d), aux, dropped


def moe_apply_expert_parallel(p, cfg, x, mesh, shard_batch: bool = True):
    """``moe_apply`` of a DTensor ``x`` as a ``local_map`` over ``mesh``:
    x sharded over the batch axes (``shard_batch``; else replicated, each
    rank routing every token) and replicated over "model", the router
    replicated, the experts sharded over "model" where E divides it (else
    gathered; FSDP shards of their other dims are gathered first); out
    laid out as x, aux and the dropped share replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    sizes = shd.mesh_shape(mesh)
    names = list(sizes)
    batch_axes = [a for a in ("pod", "data") if a in names and shard_batch]
    split = "model" in sizes and cfg.num_experts % sizes["model"] == 0
    x_pl = [Shard(0) if a in batch_axes else Replicate() for a in names]
    rep = [Replicate()] * len(names)
    ex_pl = [Shard(0) if a == "model" and split else Replicate()
             for a in names]
    # the gradients a rank computes from its local tokens and experts are
    # partial sums: over "model" for x (each rank's experts and its share
    # of aux) and the router, over the batch axes that split the tokens
    # for the router and the experts; where every rank holds the same
    # tokens (or experts) they are the same sum, replicated
    def grad(shard_on, partial_on):
        return [Shard(0) if a in shard_on else
                Partial() if a in partial_on else Replicate() for a in names]
    experts = ("model",) if split else ()
    x_grad = grad(batch_axes, experts)
    router_grad = grad((), tuple(batch_axes) + experts)
    ex_grad = grad(experts, batch_axes)
    fn = local_map(
        lambda *a: _local_moe(*a, cfg=cfg, mesh=mesh, batch_axes=batch_axes,
                              split=split),
        out_placements=(x_pl, rep, rep),
        in_placements=(x_pl, rep, ex_pl, ex_pl, ex_pl),
        in_grad_placements=(x_grad, router_grad, ex_grad, ex_grad, ex_grad),
        device_mesh=mesh, redistribute_inputs=True)
    out, aux, dropped = fn(x, p["router"], p["wi"], p["wg"], p["wo"])
    return out, (aux, dropped)
