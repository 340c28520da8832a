"""Architecture + run configuration (port of ``repro.configs.base``).

Each architecture lives in its own
``repro_torch/configs/<id>.py`` exporting ``CONFIG`` (the exact published
shape, cited) and ``smoke_config()`` (a reduced same-family variant for
CPU tests); ``get(name)`` resolves it.  ``FedConfig`` holds the federated
run's settings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import torch

if TYPE_CHECKING:  # annotation only: repro_torch.edge stays an optional layer
    from repro_torch.edge.runtime import EdgeConfig


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    source: str  # citation for the config numbers
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0          # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1         # apply MoE FFN every Nth layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0        # hybrid: one attention layer per `attn_every`
    # --- attention details ---
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_variant: str = "full"      # "full" | "sliding_window"
    window: int = 4096
    is_encoder: bool = False
    frontend: Optional[str] = None  # None | "audio_embed" | "vq_tokens"
    # --- numerics / optimizer plumbing ---
    dtype: str = "bfloat16"
    remat: bool = True
    lbfgs_m: int = 10
    lbfgs_dtype: str = "bfloat16"
    fim_mode: str = "microbatch"    # "per_example" | "microbatch"
    moe_group: int = 1024           # tokens per MoE dispatch group
    attn_q_chunk: int = 256
    fsdp: bool = False              # shard params over data axes too
    grad_accum_dtype: str = "float32"
    train_n_micro: int = 0          # 0 = launcher default

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), for rooflines."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embedding (+ tied head)
        if not self.is_encoder and self.vocab_size:
            n += self.vocab_size * d  # untied LM head
        for layer in range(self.num_layers):
            if self._layer_is_attention(layer):
                n += d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
                n += (self.num_heads * hd) * d
                n += 2 * d  # norms
            else:  # mamba mixer
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                n += d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d + 2 * d
            if self._layer_is_moe(layer):
                n += self.num_experts * (3 * d * self.d_ff) + d * self.num_experts
            elif self.d_ff:
                n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of num_experts)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        moe_layers = sum(self._layer_is_moe(i) for i in range(self.num_layers))
        expert_params = moe_layers * self.num_experts * 3 * d * self.d_ff
        active_expert = moe_layers * self.top_k * 3 * d * self.d_ff
        return self.param_count() - expert_params + active_expert

    def _layer_is_attention(self, layer: int) -> bool:
        if self.family in ("ssm",):
            return False
        if self.attn_every:
            return (layer % self.attn_every) == (self.attn_every - 1)
        return True

    def _layer_is_moe(self, layer: int) -> bool:
        if not self.num_experts:
            return False
        return (layer % self.moe_every) == (self.moe_every - 1)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class FedConfig:
    """Federated-learning run settings (paper's Table I symbols)."""
    num_clients: int = 100       # K
    participation: float = 0.2   # q (paper uses C)
    local_epochs: int = 5        # E
    batch_size: int = 15         # B
    lbfgs_m: int = 10            # m
    learning_rate: float = 0.05  # eta (first-order / local SGD)
    second_order_lr: float = 1.0 # eta for the Newton-type step (Alg. 1)
    max_step_norm: float = 1.0   # trust-region clip on ||eta p_t||
    fim_damping: float = 1e-2    # lambda in  y = (Gamma + lambda I) s
    fim_ema: float = 0.95
    rounds: int = 50             # T
    noniid_l: int = 0            # 0 = IID, else labels per client
    compress: str = "none"       # upload codec spec (repro_torch.fed.codecs)
    fim_mode: str = "per_example"  # Eq. 9 diagonal: "per_example" (exact)
                                   # | "microbatch" (squared-grad proxy)
    kernels: str = "auto"        # hand-written CUDA kernels (kernels.ops):
                                 # "auto" | "on" | "off", chosen per tensor
                                 # device — see repro_torch.kernels.ops
    prox_mu: float = 0.1         # FedProx proximal coefficient
    seed: int = 0
    # Optional resource-constrained edge simulation (repro_torch.edge):
    # wireless channels, heterogeneous devices, scheduling, async
    # aggregation.  None = the paper's cost-free instantaneous clients.
    edge: Optional["EdgeConfig"] = None

    def __post_init__(self) -> None:
        # late import: fed.codecs imports the kernel layer
        from repro_torch.fed import codecs
        try:
            codecs.make(self.compress)
        except ValueError as e:
            raise ValueError(f"FedConfig.compress: {e}") from None
        if self.kernels not in ("auto", "on", "off"):
            raise ValueError(
                f"FedConfig.kernels must be 'auto', 'on' or 'off', "
                f"got {self.kernels!r}")
        if self.fim_mode not in ("per_example", "microbatch"):
            raise ValueError(
                f"FedConfig.fim_mode must be 'per_example' or 'microbatch', "
                f"got {self.fim_mode!r}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"FedConfig.participation must be in (0, 1], "
                f"got {self.participation}")
        if self.prox_mu < 0.0:
            raise ValueError(
                f"FedConfig.prox_mu must be >= 0, got {self.prox_mu}")


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        _load_all()  # idempotent; a direct config import may have run first
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


# the architectures this repository is assigned, in the reference's order
# (the dry run's "--arch all")
ASSIGNED = [
    "dbrx-132b", "phi4-mini-3.8b", "granite-20b", "jamba-v0.1-52b",
    "qwen3-32b", "mamba2-370m", "qwen3-moe-235b-a22b", "granite-8b",
    "hubert-xlarge", "chameleon-34b",
]


def _load_all() -> None:
    # Import for registration side effects.
    from repro_torch.configs import (  # noqa: F401
        chameleon_34b, dbrx_132b, granite_8b, granite_20b, hubert_xlarge,
        jamba_52b, mamba2_370m, phi4_mini, qwen3_32b, qwen3_moe_235b,
    )
