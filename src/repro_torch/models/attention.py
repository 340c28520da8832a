"""Attention: GQA/MQA/MHA with RoPE, optional sliding window, and KV-cache
decode with a ring buffer for the sliding window (port of
``repro.models.attention``, forward only).

Prefill on a CUDA tensor goes through the hand-written flash kernel
(``kernels.ops.flash_attention``), which computes the function of the
reference's q-chunked ``_chunked_attention`` (as the reference's Pallas
kernel does on the TPU); the chunked plain path runs on the CPU and under
``kernels="off"``.  Decode attention is plain PyTorch, as it is plain
``jnp.einsum`` in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import apply_rope, dense_init, rms_norm


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


def _project_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


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


def attn_apply(p, cfg, x, causal: bool = True, kernels: str = "auto"):
    """Full-sequence attention (prefill) at positions 0..S-1.  ``kernels``
    picks the path as ``ops.resolve`` does: the flash kernel on a CUDA
    tensor under "auto"/"on", the chunked plain path otherwise."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    if ops.resolve(kernels, x.device) == "kernel":
        window = cfg.window if cfg.attn_variant == "sliding_window" else 0
        # (B,S,H,hd) -> (B,H,S,hd) views: the kernel reads them by stride
        # and returns the output in q's memory layout, so the transpose
        # back is contiguous again
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, mode=kernels).transpose(1, 2)
    else:
        out = _chunked_attention(q, k, v, cfg, positions, causal)
    out = out.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim)
    return out @ p["wo"]


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


def attn_decode(p, cfg, x, cache: KVCache):
    """One-token decode. x: (B, 1, d).  Ring-buffer write at slot pos % W
    for the sliding window; for full attention the window equals the max
    context, so the slot is the position.

    The new key and value are written INTO ``cache.k``/``cache.v`` in place
    and the returned cache holds the same tensors: the reference's
    ``dynamic_update_slice`` under ``jit`` donates its buffer, and an eager
    copy would move the whole cache every step.  ``pos`` stays a device
    tensor, so a step never waits on the host."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    W = cache.k.shape[1]
    pos = cache.pos
    q, k_new, v_new = _project_qkv(p, cfg, x, pos.reshape(1))
    slot = (pos % W).reshape(1).long()
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    k, v = cache.k, cache.v

    KV = k.shape[2]
    G = cfg.num_heads // KV
    qh = q.reshape(B, 1, KV, G, hd)
    scores = torch.einsum("bckgh,bskh->bkgcs", qh.float() * hd ** -0.5,
                          k.float())  # (B,KV,G,1,W)
    # Ring-buffer validity: after writing position `pos`, the cache holds the
    # last min(pos+1, W) positions.  Before the first wrap only slots
    # 0..pos are populated; after wrapping every slot is live.
    slots = torch.arange(W, device=x.device)
    valid = (pos >= W) | (slots <= pos)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgcs,bskh->bckgh", probs, v.float())
    out = out.reshape(B, 1, cfg.num_heads * hd).to(x.dtype)
    return out @ p["wo"], KVCache(k=k, v=v, pos=pos + 1)
