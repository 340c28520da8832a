"""Attention: GQA/MQA/MHA with RoPE, optional sliding window, and KV-cache
decode with a ring buffer for the sliding window (port of
``repro.models.attention``).

Full-sequence attention on a CUDA tensor goes through the hand-written
flash kernel (``kernels.ops.flash_attention``), which computes the function
of the reference's q-chunked ``_chunked_attention`` (as the reference's
Pallas kernel does on the TPU); under autograd its bf16 backward (the
reference trains through its jnp ``_chunked_attention``).  The chunked
plain path is the CPU path and the oracle: it runs on the CPU, under
``kernels="off"``, on a mesh, and under autograd for inputs the kernel's
backward does not take (f32, another head dim).  Decode attention is plain
PyTorch, as it is plain ``jnp.einsum`` in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (apply_rope, constrain, dense_init,
                                       rms_norm, split_heads)
from repro_torch.utils import sharding as shd

# attn_apply calls with a gradient flowing that took the plain chunked path
# (the card tests read it beside flash_attention.BWD_CALLS)
PLAIN_GRAD_CALLS = 0


def attn_init(generator: torch.Generator, cfg, stack: int | None = None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    lead = (stack,) if stack else ()
    dtype = cfg.activation_dtype
    params = {
        "wq": dense_init(generator, lead + (d, cfg.num_heads * hd), dtype),
        "wk": dense_init(generator, lead + (d, cfg.num_kv_heads * hd), dtype),
        "wv": dense_init(generator, lead + (d, cfg.num_kv_heads * hd), dtype),
        "wo": dense_init(generator, lead + (cfg.num_heads * hd, d), dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.ones(lead + (hd,), dtype=dtype,
                                      device=generator.device)
        params["k_norm"] = torch.ones(lead + (hd,), dtype=dtype,
                                      device=generator.device)
    return params


def attn_axes(cfg, stack: int | None = None) -> dict:
    """The logical axes of ``attn_init``'s tree."""
    pre = "layers," if stack else ""
    axes = {"wq": pre + "embed,qkv", "wk": pre + "embed,qkv",
            "wv": pre + "embed,qkv", "wo": pre + "qkv,embed"}
    if cfg.qk_norm:
        axes["q_norm"] = pre + "head_dim"
        axes["k_norm"] = pre + "head_dim"
    return axes


def _project_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = split_heads(x @ p["wq"], cfg.num_heads, "batch,seq,heads")
    k = split_heads(x @ p["wk"], cfg.num_kv_heads, "batch,seq,kv_heads")
    v = split_heads(x @ p["wv"], cfg.num_kv_heads, "batch,seq,kv_heads")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch,seq,heads,head_dim")
    k = constrain(k, "batch,seq,kv_heads,head_dim")
    v = constrain(v, "batch,seq,kv_heads,head_dim")
    return q, k, v


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` of attention tensors (batch, seq, heads, hd), whose
    output keeps (batch, seq, heads, ...) in front; on a
    mesh (DTensor q) a ``local_map`` of it: attention is independent over
    the batch and the heads, so each rank attends its own shards with no
    communication.  k and v are laid out as q's heads; where q's heads are
    sharded over mesh axes that KV does not divide, k and v are first
    repeated to one head a query head (the GQA fold, query head h reading
    KV head h // G, keeps each rank's query heads beside their KV heads
    only where KV divides).  The same scores either way."""
    if not shd.is_dtensor(q):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    H, KV = q.shape[2], k.shape[2]
    mesh = q.device_mesh
    ways = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                     if p.is_shard(2))
    if H != KV and KV % ways:
        k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    pl = list(q.placements)
    return local_map(fn, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh, redistribute_inputs=True)(
                         q, k, v)


def _chunked_attention(q, k, v, cfg, positions, causal: bool):
    """q:(B,S,H,hd) k,v:(B,S,KV,hd) -> (B,S,H,hd).

    Loops over query chunks (``cfg.attn_q_chunk``, halved until it divides
    S); each attends against the full masked key set, so peak score memory
    is O(chunk * S)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV  # query heads per kv head
    chunk = min(cfg.attn_q_chunk, S)
    while S % chunk:
        chunk //= 2
    scale = hd ** -0.5
    qs = q.reshape(B, S // chunk, chunk, KV, G, hd)
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(S // chunk):
        pq = positions[i * chunk:(i + 1) * chunk]
        scores = torch.einsum("bckgh,bskh->bkgcs", qs[:, i].float() * scale, kf)
        mask = torch.ones((chunk, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pq[:, None] >= positions[None, :]
        if cfg.attn_variant == "sliding_window":
            mask &= positions[None, :] > (pq[:, None] - cfg.window)
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgcs,bskh->bckgh", probs, vf)
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def _takes_kernel(q, kernels: str, grad: bool) -> bool:
    """The flash kernel where ``ops.resolve`` gives "kernel" (a CUDA tensor
    under "auto"/"on") and q is no DTensor; with a gradient flowing, only
    where its backward takes the inputs (bf16, a head dim it has)."""
    if ops.resolve(kernels, q.device) != "kernel" or shd.is_dtensor(q):
        return False
    return not grad or ops.flash_takes_grad(q.dtype, q.shape[-1])


def attn_apply(p, cfg, x, causal: bool = True, kernels: str = "auto"):
    """Full-sequence attention (train / prefill) at positions 0..S-1.
    ``kernels`` picks the path as ``ops.resolve`` does: the flash kernel on
    a CUDA tensor under "auto"/"on", forward and, when a gradient flows
    through q, k or v, backward; the chunked plain path otherwise, on a
    mesh, and under autograd where the kernel's backward does not take the
    inputs (``_takes_kernel``)."""
    global PLAIN_GRAD_CALLS
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if _takes_kernel(q, kernels, grad):
        window = cfg.window if cfg.attn_variant == "sliding_window" else 0
        # (B,S,H,hd) -> (B,H,S,hd) views: the kernel reads them by stride
        # and returns the output in q's memory layout, so the transpose
        # back is contiguous again
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, mode=kernels).transpose(1, 2)
        out = out.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    else:
        if grad:
            PLAIN_GRAD_CALLS += 1
        # the heads merged where they lie (on a mesh, inside each rank's
        # local attention: DTensor could not split a shard of the merged
        # dim back into heads in the backward)
        out = _on_local_heads(lambda q, k, v: _chunked_attention(
            q, k, v, cfg, positions, causal).flatten(2), q, k, v)
    return constrain(out @ p["wo"], "batch,seq,embed")


# ---------------------------------------------------------------------------
# Decode with KV cache
# ---------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor     # (B, W, KV, hd)
    v: torch.Tensor     # (B, W, KV, hd)
    pos: torch.Tensor   # () int32 — absolute position of the next token


def cache_init(cfg, batch: int, window: int, dtype, device) -> KVCache:
    shape = (batch, window, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def cache_axes() -> KVCache:
    return KVCache(k="batch,window,kv_heads,head_dim",
                   v="batch,window,kv_heads,head_dim", pos="")


def attn_decode(p, cfg, x, cache: KVCache):
    """One-token decode. x: (B, 1, d).  Ring-buffer write at slot pos % W
    for the sliding window; for full attention the window equals the max
    context, so the slot is the position.

    The new key and value are written INTO ``cache.k``/``cache.v`` in place
    and the returned cache holds the same tensors: the reference's
    ``dynamic_update_slice`` under ``jit`` donates its buffer, and an eager
    copy would move the whole cache every step.  ``pos`` stays a device
    tensor, so a step never waits on the host.  On a mesh (a DTensor
    cache) the write and the attention run on each rank's shards of the
    cache (``local_map``), q laid out as the cache's heads."""
    B = x.shape[0]
    pos = cache.pos
    q, k_new, v_new = _project_qkv(p, cfg, x, pos.reshape(1))
    if shd.is_dtensor(cache.k):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        pl = list(cache.k.placements)
        rep = [Replicate()] * len(pl)
        out = local_map(
            lambda *a: _decode_local(*a, cfg), out_placements=pl,
            in_placements=(pl, pl, pl, pl, pl, rep),
            device_mesh=cache.k.device_mesh, redistribute_inputs=True)(
                q, k_new, v_new, cache.k, cache.v, pos)
    else:
        out = _decode_local(q, k_new, v_new, cache.k, cache.v, pos, cfg)
    out = out.reshape(B, 1, cfg.num_heads * cfg.resolved_head_dim).to(x.dtype)
    return out @ p["wo"], KVCache(k=cache.k, v=cache.v, pos=pos + 1)


def _decode_local(q, k_new, v_new, k, v, pos, cfg):
    """The cache write at slot pos % W and one query's attention over the
    cache: (B, 1, H, hd) f32."""
    B, _, H, hd = q.shape
    W = k.shape[1]
    slot = (pos % W).reshape(1).long()
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))
    KV = k.shape[2]
    qh = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bckgh,bskh->bkgcs", qh.float() * hd ** -0.5,
                          k.float())  # (B,KV,G,1,W)
    # Ring-buffer validity: after writing position `pos`, the cache holds the
    # last min(pos+1, W) positions.  Before the first wrap only slots
    # 0..pos are populated; after wrapping every slot is live.
    slots = torch.arange(W, device=q.device)
    valid = (pos >= W) | (slots <= pos)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs, v.float())
    return out.reshape(B, 1, H, hd)
