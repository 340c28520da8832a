"""Jamba-style hybrid stack: Mamba + attention at a 1:7 ratio, MoE every
second FFN (arXiv:2403.19887; port of ``repro.models.hybrid``).

A *period* of 8 layers is three identical "mm" blocks (mamba + dense FFN,
mamba + MoE FFN) followed by one "ma" block (mamba + dense FFN, attention +
MoE FFN): per 8 layers 7 Mamba, 1 attention, 4 MoE and 4 dense FFNs.  The
parameters keep the reference's restacked layout, ``(P, 3, ...)`` for the
mm blocks and ``(P, ...)`` for the ma block; Python loops over periods and
blocks take the place of its nested ``lax.scan``, and under autograd with
``cfg.remat`` each mm block and each period is recomputed in the backward
(nested ``torch.utils.checkpoint``, the reference's nested
``jax.checkpoint``).  Prefill attention runs the flash kernel on the card
(``attention.attn_apply``); the loss runs the plain path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.layers import (constrain, dense_init, embed_init,
                                       mlp_apply, mlp_axes, mlp_init, rms_norm)
from repro_torch.models.transformer import (_chunked_ce, _layer, embed_lookup,
                                            logits_fn, prefix_axes,
                                            stack_cache)

PERIOD = 8
MM_PER_PERIOD = 3


def _periods(cfg) -> int:
    if cfg.num_layers % PERIOD:
        raise ValueError(f"{cfg.name}: the jamba stack needs a multiple of "
                         f"{PERIOD} layers, got {cfg.num_layers}")
    return cfg.num_layers // PERIOD


def _restack(tree: dict, P: int, inner: int) -> dict:
    """(P*inner, ...) stacked leaves -> (P, inner, ...)."""
    return {k: v.reshape((P, inner) + v.shape[1:]) for k, v in tree.items()}


def init_params(cfg, generator: torch.Generator) -> dict:
    """-> params on the generator's device in the reference's structure;
    ``ValueError`` unless ``cfg.num_layers`` is a multiple of 8."""
    P = _periods(cfg)
    d, dtype, dev = cfg.d_model, cfg.activation_dtype, generator.device
    n = P * MM_PER_PERIOD
    mm = {name: _restack(mamba2.mamba_init(generator, cfg, stack=n), P,
                         MM_PER_PERIOD) for name in ("m1", "m2")}
    mm["ffn_d"] = _restack(mlp_init(generator, d, cfg.d_ff, dtype, stack=n), P,
                           MM_PER_PERIOD)
    mm["ffn_e"] = _restack(moe.moe_init(generator, cfg, stack=n), P,
                           MM_PER_PERIOD)
    for name in ("ln_m1", "ln_f1", "ln_m2", "ln_f2"):
        mm[name] = torch.ones((P, MM_PER_PERIOD, d), dtype=dtype, device=dev)
    ma = {"m": mamba2.mamba_init(generator, cfg, stack=P),
          "ffn_d": mlp_init(generator, d, cfg.d_ff, dtype, stack=P),
          "attn": attn.attn_init(generator, cfg, stack=P),
          "ffn_e": moe.moe_init(generator, cfg, stack=P)}
    for name in ("ln_m", "ln_f1", "ln_a", "ln_f2"):
        ma[name] = torch.ones((P, d), dtype=dtype, device=dev)
    return {"embed": embed_init(generator, (cfg.vocab_size, d), dtype),
            "mm": mm, "ma": ma,
            "final_ln": torch.ones((d,), dtype=dtype, device=dev),
            "head": dense_init(generator, (d, cfg.vocab_size), dtype)}


def param_axes(cfg) -> dict:
    """The logical-axis tree of ``init_params``'s params: the reference's,
    the restacked (P, 3, ...) leaves with a second "layers"."""
    _periods(cfg)
    mm = {name: prefix_axes(mamba2.mamba_axes(stack=True))
          for name in ("m1", "m2")}
    mm["ffn_d"] = prefix_axes(mlp_axes(stack=True))
    mm["ffn_e"] = prefix_axes(moe.moe_axes(stack=True))
    for name in ("ln_m1", "ln_f1", "ln_m2", "ln_f2"):
        mm[name] = "layers,layers,embed"
    ma = {"m": mamba2.mamba_axes(stack=True), "ffn_d": mlp_axes(stack=True),
          "attn": attn.attn_axes(cfg, stack=True),
          "ffn_e": moe.moe_axes(stack=True)}
    for name in ("ln_m", "ln_f1", "ln_a", "ln_f2"):
        ma[name] = "layers,embed"
    return {"embed": "vocab,embed", "mm": mm, "ma": ma, "final_ln": "embed",
            "head": "embed,vocab"}


def _mm_block(p, cfg, h, aux):
    h = h + mamba2.mamba_apply(p["m1"], cfg, rms_norm(h, p["ln_m1"]))
    h = h + mlp_apply(p["ffn_d"], rms_norm(h, p["ln_f1"]))
    h = h + mamba2.mamba_apply(p["m2"], cfg, rms_norm(h, p["ln_m2"]))
    out, (a, _) = moe.moe_apply(p["ffn_e"], cfg, rms_norm(h, p["ln_f2"]))
    return h + out, aux + a


def _ma_block(p, cfg, h, aux, kernels: str):
    h = h + mamba2.mamba_apply(p["m"], cfg, rms_norm(h, p["ln_m"]))
    h = h + mlp_apply(p["ffn_d"], rms_norm(h, p["ln_f1"]))
    h = h + attn.attn_apply(p["attn"], cfg, rms_norm(h, p["ln_a"]), True,
                            kernels)
    out, (a, _) = moe.moe_apply(p["ffn_e"], cfg, rms_norm(h, p["ln_f2"]))
    return h + out, aux + a


def _period(mm_p, ma_p, cfg, h, aux, kernels: str, remat: bool):
    for i in range(MM_PER_PERIOD):
        mp = _layer(mm_p, i)
        if remat:
            h, aux = checkpoint(_mm_block, mp, cfg, h, aux, use_reentrant=False)
        else:
            h, aux = _mm_block(mp, cfg, h, aux)
        h = constrain(h, "batch,seq,embed")
    return _ma_block(ma_p, cfg, h, aux, kernels)


def forward(params, cfg, tokens, kernels: str = "auto"):
    """tokens (B, S) at positions 0..S-1 -> (hidden (B, S, d), the MoE aux
    losses summed in f32).  ``kernels`` is the attention's kernel mode."""
    x = constrain(embed_lookup(params["embed"], tokens), "batch,seq,embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in range(params["ma"]["ln_m"].shape[0]):
        mm_p, ma_p = _layer(params["mm"], p), _layer(params["ma"], p)
        if remat:
            x, aux = checkpoint(_period, mm_p, ma_p, cfg, x, aux, kernels, True,
                                use_reentrant=False)
        else:
            x, aux = _period(mm_p, ma_p, cfg, x, aux, kernels, False)
        x = constrain(x, "batch,seq,embed")
    return rms_norm(x, params["final_ln"]), aux


def lm_loss(params, cfg, batch):
    """Next-token LM loss plus ``router_aux_coef`` times the aux loss, as
    ``transformer.lm_loss``; attention runs the plain path."""
    tokens = batch["tokens"]
    hidden, aux = forward(params, cfg, tokens, kernels="off")
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]),
                      torch.zeros_like(tokens[:, :1])], dim=1).float()
    ce = _chunked_ce(params, cfg, hidden, labels, mask)
    return ce + cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
class HybridCache(NamedTuple):
    mm_m1: mamba2.MambaState   # (P, 3, ...)
    mm_m2: mamba2.MambaState   # (P, 3, ...)
    ma_m: mamba2.MambaState    # (P, ...)
    ma_kv: attn.KVCache        # (P, ...)
    pos: torch.Tensor          # () int32 — absolute position of the next token


def init_cache(cfg, batch: int, context: int, device) -> HybridCache:
    P = _periods(cfg)
    window = (min(cfg.window, context) if cfg.attn_variant == "sliding_window"
              else context)
    st = mamba2.state_init(cfg, batch, device)
    kv = attn.cache_init(cfg, batch, window, cfg.activation_dtype, device)
    return HybridCache(
        mm_m1=stack_cache(st, (P, MM_PER_PERIOD)),
        mm_m2=stack_cache(st, (P, MM_PER_PERIOD)),
        ma_m=stack_cache(st, (P,)),
        ma_kv=stack_cache(kv, (P,)),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def cache_axes(cfg) -> HybridCache:
    """The logical axes of ``init_cache``'s cache."""
    st, kv = mamba2.state_axes(), attn.cache_axes()
    return HybridCache(mm_m1=prefix_axes(st, "layers,layers,"),
                       mm_m2=prefix_axes(st, "layers,layers,"),
                       ma_m=prefix_axes(st), ma_kv=prefix_axes(kv), pos="")


def decode_step(params, cfg, cache: HybridCache, token):
    """token (B, 1) -> (logits (B, 1, V), cache); the SSM states and the
    keys and values are written into ``cache``'s tensors in place."""
    h = params["embed"][token]
    for p in range(params["ma"]["ln_m"].shape[0]):
        mm_p, ma_p = _layer(params["mm"], p), _layer(params["ma"], p)
        for i in range(MM_PER_PERIOD):
            mp = _layer(mm_p, i)
            h = h + mamba2.decode_in_place(mp["m1"], cfg, rms_norm(h, mp["ln_m1"]),
                                           _layer(cache.mm_m1, (p, i)))
            h = h + mlp_apply(mp["ffn_d"], rms_norm(h, mp["ln_f1"]))
            h = h + mamba2.decode_in_place(mp["m2"], cfg, rms_norm(h, mp["ln_m2"]),
                                           _layer(cache.mm_m2, (p, i)))
            h = h + moe.moe_apply(mp["ffn_e"], cfg, rms_norm(h, mp["ln_f2"]))[0]
        h = h + mamba2.decode_in_place(ma_p["m"], cfg, rms_norm(h, ma_p["ln_m"]),
                                       _layer(cache.ma_m, p))
        h = h + mlp_apply(ma_p["ffn_d"], rms_norm(h, ma_p["ln_f1"]))
        kv = _layer(cache.ma_kv, p)._replace(pos=cache.pos)
        h = h + attn.attn_decode(ma_p["attn"], cfg, rms_norm(h, ma_p["ln_a"]),
                                 kv)[0]
        h = h + moe.moe_apply(ma_p["ffn_e"], cfg, rms_norm(h, ma_p["ln_f2"]))[0]
    logits = logits_fn(params, cfg, rms_norm(h, params["final_ln"]))
    return logits, cache._replace(pos=cache.pos + 1)
