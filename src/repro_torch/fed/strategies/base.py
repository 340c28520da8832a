"""The ``FedStrategy`` protocol + registry (port of
``repro.fed.strategies.base``).

Every federated algorithm is a self-describing strategy object;
``FederatedRun`` (fed/server.py) is a generic round driver that never
branches on the algorithm name.  A strategy declares its per-round
resource footprint (``round_plan()`` -> :class:`RoundPlan`) and supplies
``client_step``, ``aggregate`` and ``server_step``.

    @register("my_alg")
    class MyStrategy(FedStrategy):
        ...
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import aggregation
from repro_torch.fed import codecs, comm
from repro_torch.utils.convert import load_like
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


@dataclass(frozen=True)
class PhasePlan:
    """One communication phase of a round (per *selected client*).

    ``codec`` declares the upload's wire format; its
    ``wire_bytes(up_floats)`` is what CommLedger metering bills.
    ``aggregatable`` payloads (gradients, Fisher diagonals) admit
    in-network tree aggregation; distinct local models do not."""
    name: str
    down_floats: float = 0.0          # broadcast floats (server -> client)
    up_floats: float = 0.0            # upload floats (client -> server)
    codec: codecs.PayloadCodec = codecs.NONE   # upload wire format
    aggregatable: bool = True

    def wire_up_bytes(self) -> float:
        """Per-client upload bytes of this phase under its codec."""
        return self.codec.wire_bytes(self.up_floats)


@dataclass(frozen=True)
class RoundPlan:
    """Everything the generic driver needs to meter one round of a
    strategy.  ``flops(n_k)`` predicts one client's round FLOPs from its
    sample count; ``summable`` marks additive payloads."""
    phases: tuple[PhasePlan, ...]
    flops: Callable[[int], float]
    summable: bool = False
    round_scalars: int = 0            # per-round scalar floats (Gram m²)
    scalars_per_client: int = 0       # per-client scalar floats (OVA masks)

    def upload_bytes(self) -> float:
        """Per-client upload wire bytes per round (all phases)."""
        return float(sum(p.wire_up_bytes() for p in self.phases))

    def downlink_bytes(self) -> float:
        """Per-client broadcast bytes per round (all phases)."""
        return float(sum(p.down_floats * comm.BYTES_F32 for p in self.phases))


class FedStrategy(abc.ABC):
    """One federated algorithm as a self-describing object.

    Owns the server-side model/optimizer state (tensors on ``device``) and
    the client functions; the driver owns sampling, metering, the codec
    generator and the client loop."""

    name: str = ""  # filled in by ``register``

    def __init__(self, model_cfg: Any, fed_cfg: Any, n_classes: int,
                 device="cuda"):
        self.mcfg = model_cfg
        self.fcfg = fed_cfg
        self.n_classes = n_classes
        self.device = resolve_device(device)
        # the run's payload codec (FedConfig.compress), with the kernel knob
        self.codec = codecs.make(fed_cfg.compress,
                                 kernels=fed_cfg.kernels)
        self._n_params_cache: Optional[int] = None
        self._plan_cache: Optional[RoundPlan] = None
        # parameters are drawn on the CPU from the seed, so a seed gives
        # the same initial model on every device
        self._build(torch.Generator().manual_seed(fed_cfg.seed))

    # -- construction ----------------------------------------------------
    @abc.abstractmethod
    def _build(self, generator: torch.Generator) -> None:
        """Initialize model params, optimizer state, and client fns."""

    # -- declaration -----------------------------------------------------
    @abc.abstractmethod
    def _make_plan(self) -> RoundPlan:
        """Declare this strategy's per-round resource footprint."""

    def round_plan(self) -> RoundPlan:
        if self._plan_cache is None:
            plan = self._make_plan()
            if self.codec.sparsifying and not plan.summable:
                raise ValueError(
                    f"codec {self.codec.spec()!r} sparsifies payload "
                    "coordinates, which is only meaningful for additive "
                    f"(summable) payloads; strategy {self.name!r} uploads "
                    "distinct models/components (summable=False)")
            self._plan_cache = plan
        return self._plan_cache

    def n_params(self) -> int:
        """Float count of ONE broadcast model."""
        if self._n_params_cache is None:
            self._n_params_cache = comm.tree_n_floats(self.params)
        return self._n_params_cache

    # -- state -----------------------------------------------------------
    def state_dict(self) -> dict:
        """Every server-side tensor that mutates across rounds: ``params``
        plus ``opt_state`` when the strategy keeps one."""
        sd: dict = {"params": self.params}
        if hasattr(self, "opt_state"):
            sd["opt_state"] = self.opt_state
        return sd

    def load_state_dict(self, state: dict) -> None:
        """Load a state of this strategy's structure — the port's own
        ``state_dict()`` or the reference's, carried across with
        ``utils.convert.from_jax`` — onto this strategy's device."""
        self.params = load_like(self.params, state["params"])
        if "opt_state" in state:
            self.opt_state = load_like(self.opt_state, state["opt_state"])

    # -- one round -------------------------------------------------------
    def round_context(self, datas: Sequence[tuple], rng: Any
                      ) -> Optional[Sequence[Any]]:
        """Optional cohort-wide pre-phase; returns per-client contexts."""
        return None

    @abc.abstractmethod
    def client_step(self, data: tuple, rng: Any,
                    context: Any = None) -> tuple[Any, torch.Tensor]:
        """One client's local update on data=(xs, ys) device tensors.
        Returns (payload, loss) with the loss a 0-d device tensor."""

    def aggregate(self, payloads: Sequence[Any],
                  weights: torch.Tensor) -> Any:
        """Weighted mean over the stacked payload trees."""
        return aggregation.weighted_mean(
            tree_map(lambda *t: torch.stack(t), *payloads), weights)

    @abc.abstractmethod
    def server_step(self, aggregate: Any) -> None:
        """Apply an aggregate to the server model/optimizer state."""

    def compress_payload(self, payload: Any, generator: torch.Generator,
                         residual: Any = None,
                         codec: Optional[codecs.PayloadCodec] = None
                         ) -> tuple[Any, Any]:
        """Round-trip the payload through ``codec`` (default: the run's).
        Returns ``(payload, new_residual)``; FederatedRun keeps the
        client's error-feedback residual and threads it back in next
        round."""
        return (codec or self.codec).roundtrip(payload, generator, residual)

    # -- evaluation ------------------------------------------------------
    def evaluate(self, x: torch.Tensor, y: torch.Tensor) -> float:
        """Test accuracy of the current server model."""
        return float(self._eval(self.params, x, y))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[..., FedStrategy]] = {}


def register(name: str, factory: Optional[Callable[..., FedStrategy]] = None):
    """Register ``factory(model_cfg, fed_cfg, n_classes, device)`` under
    ``name``.  Usable as a decorator or called directly."""

    def _do(f):
        try:
            f.name = name
        except (AttributeError, TypeError):
            pass
        _REGISTRY[name] = f
        return f

    return _do if factory is None else _do(factory)


def get(name: str) -> Callable[..., FedStrategy]:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown federated strategy {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)
