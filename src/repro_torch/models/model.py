"""Unified model API over every architecture family (port of
``repro.models.model``):

    init(cfg, generator, device)    -> params
    loss_fn(params, cfg, batch)     -> (scalar, metrics)      [train]
    prefill_fn(params, cfg, batch)  -> last-position logits   [prefill]
    init_cache(cfg, B, ctx, device) -> cache                  [decode]
    decode_fn(params, cfg, c, t)    -> (logits, cache)
    synth_batch(cfg, shape, gen)    -> a random batch of ``shape``
    param_axes(cfg), cache_axes(cfg) -> their logical-axis trees
    input_specs(cfg, shape)         -> meta tensors of a step's inputs
    input_axes(cfg, shape)          -> their logical axes

The hybrid (Jamba) family runs ``models/hybrid.py``; every other family
(dense, MoE, Mamba-2, the VLM and the audio encoder) runs
``models/transformer.py``.  The train step over ``loss_fn`` is
``launch/train.py``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import hybrid, transformer
from repro_torch.utils.device import resolve_device


def is_hybrid(cfg: ArchConfig) -> bool:
    return cfg.family == "hybrid"


def init(cfg: ArchConfig, generator: torch.Generator | None = None,
         device="cuda") -> dict:
    """Parameters drawn on ``device`` from ``generator`` (a generator on
    that device; seed 0 when None).  Runs on the card unless the caller
    asks for the CPU, and raises without CUDA."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"init: generator on {generator.device}, params "
                         f"asked for on {device}")
    mod = hybrid if is_hybrid(cfg) else transformer
    return mod.init_params(cfg, generator)


def param_axes(cfg: ArchConfig) -> dict:
    """The logical-axis tree of ``init``'s params (``utils/sharding.py``),
    the reference's ``init`` axes leaf for leaf."""
    return (hybrid if is_hybrid(cfg) else transformer).param_axes(cfg)


def cache_axes(cfg: ArchConfig):
    """The logical-axis tree of ``init_cache``'s cache."""
    return (hybrid if is_hybrid(cfg) else transformer).cache_axes(cfg)


def loss_fn(params, cfg: ArchConfig, batch):
    """(loss, {"ce", "aux"}): ``transformer.encoder_loss`` for an encoder,
    else the next-token ``lm_loss`` (the hybrid's for Jamba), the MoE aux
    loss weighted by ``router_aux_coef``; attention runs the plain path."""
    if is_hybrid(cfg):
        return hybrid.lm_loss(params, cfg, batch)
    return transformer.loss_fn(params, cfg, batch)


def forward(params, cfg: ArchConfig, inputs, kernels: str = "auto"):
    """(hidden (B, S, d), aux) of the family's stack; ``kernels`` is the
    attention's kernel mode."""
    fwd = hybrid.forward if is_hybrid(cfg) else transformer.forward
    return fwd(params, cfg, inputs, kernels=kernels)


def prefill_fn(params, cfg: ArchConfig, batch, kernels: str = "auto"):
    """Full-sequence forward returning last-position logits (prefill), or
    the last ``LOSS_CHUNK`` frames' logits for an encoder."""
    inputs = batch.get("tokens", batch.get("features"))
    hidden, _ = forward(params, cfg, inputs, kernels=kernels)
    if cfg.is_encoder:  # encode: per-frame logits
        return transformer.logits_fn(params, cfg,
                                     hidden[:, -transformer.LOSS_CHUNK:])
    return transformer.logits_fn(params, cfg, hidden[:, -1:])


def init_cache(cfg: ArchConfig, batch: int, context: int, device="cuda"):
    mod = hybrid if is_hybrid(cfg) else transformer
    return mod.init_cache(cfg, batch, context, resolve_device(device))


def decode_fn(params, cfg: ArchConfig, cache, token):
    mod = hybrid if is_hybrid(cfg) else transformer
    return mod.decode_step(params, cfg, cache, token)


def synth_batch(cfg: ArchConfig, shape: ShapeConfig,
                generator: torch.Generator) -> dict:
    """A random batch of ``shape`` (train or prefill) on the generator's
    device, in the reference's ``input_specs`` layout: int32 tokens (and
    labels) below the vocabulary, f32 frame features for an audio
    encoder."""
    B, S = shape.global_batch, shape.seq_len
    dev = generator.device

    def ints(hi):
        return torch.randint(0, max(hi, 2), (B, S), generator=generator,
                             device=dev, dtype=torch.int32)

    if cfg.frontend == "audio_embed":
        out = {"features": torch.randn((B, S, cfg.d_model),
                                       generator=generator, device=dev)}
        if shape.kind == "train":
            out["labels"] = ints(cfg.vocab_size)
        return out
    return {"tokens": ints(cfg.vocab_size)}


def supports_shape(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(supported, reason-if-not). Encoders have no decode; full-attention
    archs run long_500k only via the sliding-window variant (handled by
    shape_variant below)."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    return True, ""


def shape_variant(cfg: ArchConfig, shape: ShapeConfig) -> ArchConfig:
    """Per-shape config adjustments:
    - long_500k on full-attention archs -> sliding-window variant;
    - decode paths never remat."""
    cfg = cfg.replace(remat=shape.kind == "train" and cfg.remat)
    if shape.name == "long_500k" and cfg.family != "ssm":
        cfg = cfg.replace(attn_variant="sliding_window")
    return cfg


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta tensors standing in for the step's data arguments (the
    reference's ShapeDtypeStructs): train/prefill batches, or one decode
    token against a length-S context."""
    B, S = shape.global_batch, shape.seq_len

    def spec(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_embed":
            specs = {"features": spec((B, S, cfg.d_model), torch.float32)}
            if shape.kind == "train":
                specs["labels"] = spec((B, S), torch.int32)
            return specs
        return {"tokens": spec((B, S), torch.int32)}
    if cfg.frontend == "audio_embed":
        return {"token": spec((B, 1, cfg.d_model), torch.float32)}
    return {"token": spec((B, 1), torch.int32)}


def input_axes(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Logical axes of ``input_specs`` (batch -> data/pod)."""
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_embed":
            ax = {"features": "batch,seq,embed"}
            if shape.kind == "train":
                ax["labels"] = "batch,seq"
            return ax
        return {"tokens": "batch,seq"}
    return {"token": "batch,seq,embed" if cfg.frontend == "audio_embed"
            else "batch,seq"}
