"""Inputs and weights drawn from the run's seed: the one generator of the
benchmark's traffic.  The program and the reference are handed the same
arrays; neither draws its own.

Every seed gets the same sizes: token batches have fixed shapes and only
their ids change.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 27          # elements drawn per call when filling weights


def lm_param_shapes(cfg: dict) -> list[tuple[tuple, tuple, str]]:
    """(path, shape, init) of every leaf of the dense decoder's parameters
    in the program's layout: stacked layers, dense weights (in, out), an
    untied head.  init is "embed", "ones" or "dense"."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    hd, h, kv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    f, v = cfg["intermediate_size"], cfg["vocab_size"]
    return [
        (("embed",), (v, d), "embed"),
        (("layers", "attn", "wq"), (L, d, h * hd), "dense"),
        (("layers", "attn", "wk"), (L, d, kv * hd), "dense"),
        (("layers", "attn", "wv"), (L, d, kv * hd), "dense"),
        (("layers", "attn", "wo"), (L, h * hd, d), "dense"),
        (("layers", "ln1"), (L, d), "ones"),
        (("layers", "ffn", "wi"), (L, d, f), "dense"),
        (("layers", "ffn", "wg"), (L, d, f), "dense"),
        (("layers", "ffn", "wo"), (L, f, d), "dense"),
        (("layers", "ln2"), (L, d), "ones"),
        (("final_ln",), (d,), "ones"),
        (("head",), (d, v), "dense"),
    ]


def lm_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The decoder's weights drawn on ``device`` from the seed, in large
    f32 draws cast to ``dtype``: the embedding Normal(0, 0.02^2), dense
    weights Normal(0, 1/fan_in), norm scales one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict = {}
    for path, shape, init in lm_param_shapes(cfg):
        leaf = torch.empty(shape, dtype=dtype, device=device)
        if init == "ones":
            leaf.fill_(1.0)
        else:
            scale = 0.02 if init == "embed" else 1.0 / math.sqrt(shape[-2])
            flat = leaf.view(-1)
            for at in range(0, flat.numel(), CHUNK):
                part = flat[at:at + CHUNK]
                part.copy_(torch.randn(part.numel(), generator=gen,
                                       device=device).mul_(scale))
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return params


def zipf_tokens(shape: tuple, vocab: int, seed: int, stream: int,
                device) -> torch.Tensor:
    """int32 ids of ``shape`` drawn from Zipf(1) over the vocabulary (rank
    r has weight 1/r), on ``device`` by inverting the CDF."""
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (1 << 63))
    w = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(math.prod(shape), generator=gen, dtype=torch.float64,
                   device=device)
    ids = torch.searchsorted(cdf, u).clamp_max_(vocab - 1)
    return ids.to(torch.int32).reshape(shape)
