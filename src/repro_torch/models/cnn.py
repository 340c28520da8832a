"""The paper's experiment CNNs (Sec. VI-A), as pure functions of a
parameter dict.

Parameters keep the reference's layout (``repro.models.cnn``): conv
weights HWIO, dense weights ``(in, out)``, inputs NHWC.  ``apply``
computes in NCHW (PyTorch's convolution layout) and permutes back to NHWC
before the flatten, so ``fc0`` sees features in the reference's order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_models import CNNConfig
from repro_torch.models.layers import dense_init


def init(cfg: CNNConfig, generator: torch.Generator, dtype=torch.float32):
    """-> params dict on the generator's device."""
    params = {}
    ch_in = cfg.input_shape[-1]
    h, w = cfg.input_shape[:2]
    for i, ch in enumerate(cfg.conv_channels):
        params[f"conv{i}"] = {
            "w": dense_init(generator, (3, 3, ch_in, ch), dtype) / 3.0,
            "b": torch.zeros((ch,), dtype=dtype),
        }
        ch_in = ch
        h, w = -(-h // cfg.pool[0]), -(-w // cfg.pool[1])
    feat = h * w * ch_in
    for j, units in enumerate(cfg.fc_units):
        params[f"fc{j}"] = {
            "w": dense_init(generator, (feat, units), dtype),
            "b": torch.zeros((units,), dtype=dtype),
        }
        feat = units
    params["out"] = {
        "w": dense_init(generator, (feat, cfg.num_classes), dtype),
        "b": torch.zeros((cfg.num_classes,), dtype=dtype),
    }
    return params


def _max_pool_same(x: torch.Tensor, pool: tuple) -> torch.Tensor:
    """The reference's ``reduce_window(max, -inf, pool, pool, "SAME")``.

    With window == stride, SAME pads ``ceil(n/s)*s - n`` cells, low half
    first; ``ceil_mode=True`` pads only at the high end, so the two agree
    exactly while that total is below 2 (true for every pool of size <= 2).
    """
    for n, s in zip(x.shape[2:], pool, strict=True):
        total = -(-n // s) * s - n
        if total // 2:
            raise ValueError(f"pool {pool} on extent {n}: SAME pads "
                             f"{total // 2} cell(s) low, which ceil_mode "
                             "does not reproduce")
    return F.max_pool2d(x, kernel_size=pool, stride=pool, ceil_mode=True)


def apply(params, cfg: CNNConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, num_classes)."""
    x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for i in range(len(cfg.conv_channels)):
        p = params[f"conv{i}"]
        w = p["w"].permute(3, 2, 0, 1)              # HWIO -> OIHW
        x = F.conv2d(x, w, p["b"], padding="same")
        x = _max_pool_same(torch.relu(x), cfg.pool)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten order
    for j in range(len(cfg.fc_units)):
        p = params[f"fc{j}"]
        x = torch.relu(x @ p["w"] + p["b"])
    p = params["out"]
    return x @ p["w"] + p["b"]


def softmax_loss(params, cfg: CNNConfig, batch) -> torch.Tensor:
    """Multi-class CE (FedAvg-style training)."""
    logits = apply(params, cfg, batch["x"]).float()
    labels = batch["y"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.mean(lse - gold)


def binary_loss(params, cfg: CNNConfig, batch) -> torch.Tensor:
    """One-vs-all component loss: sigmoid BCE on 1-logit head.
    batch["y"] in {0,1}: membership of the component's class."""
    logits = apply(params, cfg, batch["x"]).float()[:, 0]
    y = batch["y"].float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def accuracy(params, cfg: CNNConfig, x, y) -> torch.Tensor:
    return torch.mean((torch.argmax(apply(params, cfg, x), dim=-1) == y).float())


def per_example_loss_fn(cfg: CNNConfig, binary: bool = False):
    """Single-example loss closure used by the exact per-example FIM path."""
    loss = binary_loss if binary else softmax_loss

    def f(params, x, y):
        return loss(params, cfg, {"x": x[None], "y": y[None]})

    return f
