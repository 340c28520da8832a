"""Unified model API over the architecture families the port has reached
(port of ``repro.models.model``, serving only):

    init(cfg, generator, device)    -> params
    prefill_fn(params, cfg, batch)  -> last-position logits   [prefill]
    init_cache(cfg, B, ctx, device) -> cache                  [decode]
    decode_fn(params, cfg, c, t)    -> (logits, cache)

The dense, VLM and audio-encoder families run; MoE, Mamba-2 and the hybrid
raise ``NotImplementedError`` naming their slice.  The loss and the train
step are the next slice (ROADMAP section 1, item 9b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.utils.device import resolve_device


def _check(cfg: ArchConfig) -> None:
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid (Jamba) family is not ported yet "
            "(ROADMAP section 1, item 9d: models/hybrid.py)")
    transformer.check_family(cfg)


def init(cfg: ArchConfig, generator: torch.Generator | None = None,
         device="cuda") -> dict:
    """Parameters drawn on ``device`` from ``generator`` (a generator on
    that device; seed 0 when None).  Runs on the card unless the caller
    asks for the CPU, and raises without CUDA."""
    _check(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"init: generator on {generator.device}, params "
                         f"asked for on {device}")
    return transformer.init_params(cfg, generator)


def prefill_fn(params, cfg: ArchConfig, batch, kernels: str = "auto"):
    """Full-sequence forward returning last-position logits (prefill), or
    the last ``LOSS_CHUNK`` frames' logits for an encoder."""
    _check(cfg)
    inputs = batch.get("tokens", batch.get("features"))
    hidden, _ = transformer.forward(params, cfg, inputs, kernels=kernels)
    if cfg.is_encoder:  # encode: per-frame logits
        return transformer.logits_fn(params, cfg,
                                     hidden[:, -transformer.LOSS_CHUNK:])
    return transformer.logits_fn(params, cfg, hidden[:, -1:])


def init_cache(cfg: ArchConfig, batch: int, context: int, device="cuda"):
    _check(cfg)
    return transformer.init_cache(cfg, batch, context, resolve_device(device))


def decode_fn(params, cfg: ArchConfig, cache, token):
    _check(cfg)
    return transformer.decode_step(params, cfg, cache, token)


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
