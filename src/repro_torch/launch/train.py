"""LLM-scale step factories (port of ``repro.launch.train``): the serving
steps only.  The federated train step (FIM-L-BFGS over microbatch
cohorts) is the next slice (ROADMAP section 1, item 9b)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as zoo


def make_prefill_step(cfg: ArchConfig, kernels: str = "auto"):
    """(params, batch) -> last-position logits; ``kernels`` is the
    attention's kernel mode."""
    def prefill_step(params, batch):
        return zoo.prefill_fn(params, cfg, batch, kernels=kernels)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, token) -> (logits, cache), one greedy-decode step."""
    def serve_step(params, cache, token):
        return zoo.decode_fn(params, cfg, cache, token)

    return serve_step
