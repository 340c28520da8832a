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
-> ``assign_slots`` -> ``dispatch`` -> ``expert_ffn`` -> ``combine``.  The
reference's expert-parallel ``shard_map`` path waits for the mesh slice
of the port (ROADMAP section 1, item 9).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


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
    picks dropped at capacity."""
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
