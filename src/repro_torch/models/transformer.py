"""Decoder / encoder stacks: the dense, MoE, pure-SSM (Mamba-2),
audio-encoder and VLM families (port of ``repro.models.transformer``:
forward, the losses, decode).

Layers are stored *stacked* (leading ``num_layers`` dim, the reference's
layout) and run as a Python loop over the stack, which takes the place of
the reference's ``lax.scan``; under autograd with ``cfg.remat`` each layer
is recomputed in the backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of the scanned body).  The hybrid (Jamba) family lives
in ``models/hybrid.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import (constrain, dense_init, embed_init,
                                       mlp_apply, mlp_axes, mlp_init, rms_norm)

LOSS_CHUNK = 512  # sequence chunk for the CE loss (bounds logits memory)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree or cache (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):  # a NamedTuple cache
        return type(tree)(*(_layer(t, i) for t in tree))
    return tree[i]


def stack_cache(cache: tuple, lead: tuple) -> tuple:
    """A NamedTuple cache of one layer repeated over ``lead`` dims (copies)."""
    return type(cache)(*(t.expand(lead + t.shape).clone() for t in cache))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg, generator: torch.Generator) -> dict:
    """-> params dict on the generator's device, in the reference's
    structure and layout (its logical axes: ``param_axes``)."""
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
    if cfg.family == "ssm":
        layers = {"mixer": mamba2.mamba_init(generator, cfg, stack=L)}
    else:
        layers = {"attn": attn.attn_init(generator, cfg, stack=L)}
    layers["ln1"] = ones(L, d)
    if cfg.d_ff:
        layers["ffn"] = (moe.moe_init(generator, cfg, stack=L) if cfg.num_experts
                         else mlp_init(generator, d, cfg.d_ff, dtype, stack=L))
        layers["ln2"] = ones(L, d)
    params["layers"] = layers
    params["final_ln"] = ones(d)
    params["head"] = dense_init(generator, (d, cfg.vocab_size), dtype)
    return params


def prefix_axes(tree, pre: str = "layers,"):
    """Every axes string of ``tree`` with ``pre`` in front ("" becomes
    ``pre`` without its comma)."""
    if isinstance(tree, dict):
        return {k: prefix_axes(v, pre) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(prefix_axes(v, pre) for v in tree))
    return pre + tree if tree else pre.rstrip(",")


def param_axes(cfg) -> dict:
    """The logical-axis tree of ``init_params``'s params, leaf for leaf the
    reference's ``init_params`` axes."""
    embed = "embed,embed" if cfg.frontend == "audio_embed" else "vocab,embed"
    layers = ({"mixer": mamba2.mamba_axes(stack=True)} if cfg.family == "ssm"
              else {"attn": attn.attn_axes(cfg, stack=True)})
    layers["ln1"] = "layers,embed"
    if cfg.d_ff:
        layers["ffn"] = (moe.moe_axes(stack=True) if cfg.num_experts
                         else mlp_axes(stack=True))
        layers["ln2"] = "layers,embed"
    return {"embed": embed, "layers": layers, "final_ln": "embed",
            "head": "embed,vocab"}


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
def embed_inputs(params, cfg, inputs):
    if cfg.frontend == "audio_embed":
        x = inputs.to(cfg.activation_dtype) @ params["embed"]
    else:
        x = embed_lookup(params["embed"], inputs)
    return constrain(x, "batch,seq,embed")


def embed_lookup(table, ids):
    """Rows ``ids`` of the (vocab, d) table; on a mesh the table is
    gathered over the vocab's model shards first (DTensor's vocab-parallel
    lookup cannot take a Partial cotangent in its backward)."""
    table = constrain(table, "vocab,embed", {"vocab": None})
    return torch.nn.functional.embedding(ids, table)


def _layer_body(lp, cfg, x, causal: bool, kernels: str):
    """-> (hidden, the layer's MoE aux loss, 0 without experts)."""
    z = rms_norm(x, lp["ln1"])
    h = x + (mamba2.mamba_apply(lp["mixer"], cfg, z) if cfg.family == "ssm"
             else attn.attn_apply(lp["attn"], cfg, z, causal, kernels))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff:
        z = rms_norm(h, lp["ln2"])
        if cfg.num_experts:
            out, (aux, _) = moe.moe_apply(lp["ffn"], cfg, z)
        else:
            out = mlp_apply(lp["ffn"], z)
        h = h + out
    return h, aux


def forward(params, cfg, inputs, kernels: str = "auto"):
    """inputs: (B,S) int tokens, or (B,S,d) embeddings for audio, at
    positions 0..S-1.  Returns (hidden (B,S,d), total_aux_loss), the
    layers' MoE aux losses summed in f32 (0 without MoE).  ``kernels`` is
    the attention's kernel mode (``kernels.ops.resolve``; under autograd
    the flash kernel's backward runs where it takes the inputs, see
    ``attention.attn_apply``).  With
    ``cfg.remat`` and grad mode on, each layer keeps only its input for
    the backward and is run again there."""
    x = embed_inputs(params, cfg, inputs)
    causal = not cfg.is_encoder
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(params["layers"]["ln1"].shape[0]):
        lp = _layer(params["layers"], i)
        if remat:
            x, a = checkpoint(_layer_body, lp, cfg, x, causal, kernels,
                              use_reentrant=False)
        else:
            x, a = _layer_body(lp, cfg, x, causal, kernels)
        x = constrain(x, "batch,seq,embed")
        aux = aux + a
    return rms_norm(x, params["final_ln"]), aux


def logits_fn(params, cfg, hidden):
    """(hidden @ head) in the activation dtype, then f32."""
    return constrain((hidden @ params["head"]).float(), "batch,seq,vocab")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def _chunked_ce(params, cfg, hidden, labels, mask):
    """Cross-entropy evaluated in sequence chunks (``LOSS_CHUNK``, halved
    until it divides S) to bound logits memory: the masked sum of
    ``lse - gold`` over the count of the mask, at least 1."""
    B, S, _ = hidden.shape
    chunk = min(LOSS_CHUNK, S)
    while S % chunk:
        chunk //= 2
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S, chunk):
        lg = logits_fn(params, cfg, hidden[:, c:c + chunk])    # (B,chunk,V) f32
        # the gold logit is gathered from the whole vocabulary: on a mesh
        # the chunk's logits are gathered over the model axis first
        lg = constrain(lg, "batch,seq,vocab", {"vocab": None})
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, labels[:, c:c + chunk, None].long())[..., 0]
        mc = mask[:, c:c + chunk]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params, cfg, batch, kernels: str = "auto"):
    """Next-token LM loss.  batch: {"tokens": (B,S)}.  The labels roll the
    first token to the end, where the mask drops it.  ``kernels`` is the
    attention's kernel mode, as ``forward``'s: on the card a bf16 model's
    attention runs the flash kernel forward and backward."""
    tokens = batch["tokens"]
    hidden, aux = forward(params, cfg, tokens, kernels=kernels)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1).float()
    ce = _chunked_ce(params, cfg, hidden, labels, mask)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


def encoder_loss(params, cfg, batch, kernels: str = "auto"):
    """Masked-unit prediction (hubert-style): per-frame classification.
    batch: {"features": (B,S,d), "labels": (B,S)} (+ an optional f32
    "mask").  ``kernels``: the attention's kernel mode, as ``forward``'s."""
    feats, labels = batch["features"], batch["labels"]
    hidden, aux = forward(params, cfg, feats, kernels=kernels)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce = _chunked_ce(params, cfg, hidden, labels, mask)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


def loss_fn(params, cfg, batch, kernels: str = "auto"):
    return (encoder_loss(params, cfg, batch, kernels) if cfg.is_encoder
            else lm_loss(params, cfg, batch, kernels))


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
class DecodeCache(NamedTuple):
    layer_cache: tuple         # stacked (L, ...) KVCache or MambaState
    pos: torch.Tensor          # () int32 — absolute position of the next token


def init_cache(cfg, batch: int, context: int, device) -> DecodeCache:
    if cfg.family == "ssm":
        layer = mamba2.state_init(cfg, batch, device)
    else:
        window = (min(cfg.window, context)
                  if cfg.attn_variant == "sliding_window" else context)
        layer = attn.cache_init(cfg, batch, window, cfg.activation_dtype, device)
    return DecodeCache(stack_cache(layer, (cfg.num_layers,)),
                       torch.zeros((), dtype=torch.int32, device=device))


def cache_axes(cfg) -> DecodeCache:
    """The logical axes of ``init_cache``'s cache."""
    layer = mamba2.state_axes() if cfg.family == "ssm" else attn.cache_axes()
    return DecodeCache(prefix_axes(layer), "")


def decode_step(params, cfg, cache: DecodeCache, token):
    """token: (B,1) int (or (B,1,d) audio embeds) -> (logits (B,1,V), cache).

    Writes the new keys and values (or SSM states) into ``cache``'s tensors
    in place (see ``attention.attn_decode``, ``mamba2.decode_in_place``);
    the returned cache shares them.  The position is tracked once, at the
    top level.  An MoE layer dispatches the B tokens as one group, so it
    drops picks past its capacity as the reference's decode does."""
    x = embed_inputs(params, cfg, token)
    layer_cache = cache.layer_cache
    for i in range(params["layers"]["ln1"].shape[0]):
        lp, lc = _layer(params["layers"], i), _layer(layer_cache, i)
        z = rms_norm(x, lp["ln1"])
        if cfg.family == "ssm":
            x = x + mamba2.decode_in_place(lp["mixer"], cfg, z, lc)
        else:
            x = x + attn.attn_decode(lp["attn"], cfg, z, lc._replace(
                pos=cache.pos))[0]
        if cfg.d_ff:
            z = rms_norm(x, lp["ln2"])
            x = x + (moe.moe_apply(lp["ffn"], cfg, z)[0] if cfg.num_experts
                     else mlp_apply(lp["ffn"], z))
    h = rms_norm(x, params["final_ln"])
    return logits_fn(params, cfg, h), DecodeCache(layer_cache, cache.pos + 1)
