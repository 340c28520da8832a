"""Decoder / encoder transformer stacks: the dense, audio-encoder and VLM
families (port of ``repro.models.transformer``, forward and decode only).

Layers are stored *stacked* (leading ``num_layers`` dim, the reference's
layout) and run as a Python loop over the stack, which takes the place of
the reference's ``lax.scan``.  MoE and Mamba-2 layers are later slices of
the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_init, mlp_apply,
                                       mlp_init, rms_norm)

LOSS_CHUNK = 512  # sequence chunk for the CE loss (bounds logits memory)


def check_family(cfg) -> None:
    """Raise for the layer kinds the port has not reached."""
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: Mamba-2 layers are not ported yet (ROADMAP "
            "section 1, item 9d: models/mamba2.py)")
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP section 1, "
            "item 9c: models/moe.py)")


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg, generator: torch.Generator) -> dict:
    """-> params dict on the generator's device, in the reference's
    structure and layout (its sharding axes wait for the launch slice)."""
    check_family(cfg)
    L, d = cfg.num_layers, cfg.d_model
    dtype = cfg.activation_dtype
    device = generator.device

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    params = {}
    if cfg.frontend == "audio_embed":
        # stub frontend: inputs arrive as (B, S, d_model) frame embeddings;
        # a single linear adapter stands in for the conv feature projector.
        params["embed"] = dense_init(generator, (d, d), dtype)
    else:
        params["embed"] = embed_init(generator, (cfg.vocab_size, d), dtype)
    layers = {"attn": attn.attn_init(generator, cfg, stack=L), "ln1": ones(L, d)}
    if cfg.d_ff:
        layers["ffn"] = mlp_init(generator, d, cfg.d_ff, dtype, stack=L)
        layers["ln2"] = ones(L, d)
    params["layers"] = layers
    params["final_ln"] = ones(d)
    params["head"] = dense_init(generator, (d, cfg.vocab_size), dtype)
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def embed_inputs(params, cfg, inputs):
    if cfg.frontend == "audio_embed":
        return inputs.to(cfg.activation_dtype) @ params["embed"]
    return params["embed"][inputs]


def forward(params, cfg, inputs, kernels: str = "auto"):
    """inputs: (B,S) int tokens, or (B,S,d) embeddings for audio, at
    positions 0..S-1.  Returns (hidden (B,S,d), total_aux_loss), the aux
    loss being 0 without MoE.  ``kernels`` is the attention's kernel mode
    (``kernels.ops.resolve``)."""
    check_family(cfg)
    x = embed_inputs(params, cfg, inputs)
    causal = not cfg.is_encoder
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        x = x + attn.attn_apply(lp["attn"], cfg, rms_norm(x, lp["ln1"]),
                                causal, kernels)
        if cfg.d_ff:
            x = x + mlp_apply(lp["ffn"], rms_norm(x, lp["ln2"]))
    x = rms_norm(x, params["final_ln"])
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_fn(params, cfg, hidden):
    """(hidden @ head) in the activation dtype, then f32."""
    return (hidden @ params["head"]).float()


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
class DecodeCache(NamedTuple):
    layer_cache: attn.KVCache  # stacked (L, ...) KVCache
    pos: torch.Tensor          # () int32 — absolute position of the next token


def init_cache(cfg, batch: int, context: int, device) -> DecodeCache:
    check_family(cfg)
    window = (min(cfg.window, context) if cfg.attn_variant == "sliding_window"
              else context)
    kc = attn.cache_init(cfg, batch, window, cfg.activation_dtype, device)
    stacked = attn.KVCache(*(t.expand((cfg.num_layers,) + t.shape).clone()
                             for t in kc))
    return DecodeCache(stacked, torch.zeros((), dtype=torch.int32, device=device))


def decode_step(params, cfg, cache: DecodeCache, token):
    """token: (B,1) int (or (B,1,d) audio embeds) -> (logits (B,1,V), cache).

    Writes the new keys and values into ``cache``'s tensors in place (see
    ``attention.attn_decode``); the returned cache shares them.  The
    position is tracked once, at the top level."""
    x = embed_inputs(params, cfg, token)
    layer_cache = cache.layer_cache
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        lc = attn.KVCache(k=layer_cache.k[i], v=layer_cache.v[i], pos=cache.pos)
        out, _ = attn.attn_decode(lp["attn"], cfg, rms_norm(x, lp["ln1"]), lc)
        x = x + out
        if cfg.d_ff:
            x = x + mlp_apply(lp["ffn"], rms_norm(x, lp["ln2"]))
    h = rms_norm(x, params["final_ln"])
    return logits_fn(params, cfg, h), DecodeCache(layer_cache, cache.pos + 1)
