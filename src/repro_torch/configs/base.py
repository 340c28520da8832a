"""Run configuration: ``FedConfig`` (the reference's ``configs/base.py``
also holds the LLM-scale ``ArchConfig``, which the port has not reached)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


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
    edge: Optional[Any] = None   # the edge runtime is a later slice

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
        if self.edge is not None:
            raise NotImplementedError(
                "FedConfig.edge: the edge runtime (repro.edge) is not ported "
                "yet; it lands with the 'Edge and observability' slice")
