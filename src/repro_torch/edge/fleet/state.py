"""FleetState: the population as struct-of-arrays (port of
``repro.edge.fleet.state``; numpy, the reference's code).

A thin owner of the same array state the dict path keeps inside
:class:`~repro_torch.edge.channel.Channel` and
:class:`~repro_torch.edge.device.DeviceFleet` — SNR shadowing, per-round
fades, compute rates, batteries — plus the busy mask the async tail
maintains.  ``draw`` uses the exact rng stream layout of
``EdgeRuntime`` (channel at seed+1, devices at seed+2), so a FleetState
and a runtime built from the same seed hold bit-identical populations;
``from_runtime`` wraps a live runtime's state without re-drawing.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.edge.channel import Channel, ChannelConfig
from repro_torch.edge.device import DeviceConfig, DeviceFleet


@dataclass
class FleetState:
    """Struct-of-arrays view of one simulated population."""
    channel: Channel
    fleet: DeviceFleet
    busy: np.ndarray = field(default=None)  # (N,) async in-flight mask

    def __post_init__(self):
        if self.busy is None:
            self.busy = np.zeros(self.population, dtype=bool)

    @classmethod
    def draw(cls, channel_cfg: ChannelConfig, device_cfg: DeviceConfig,
             population: int, seed: int = 0) -> "FleetState":
        """Draw a fresh population with EdgeRuntime's stream layout."""
        return cls(Channel(channel_cfg, population, seed=seed + 1),
                   DeviceFleet(device_cfg, population, seed=seed + 2))

    @classmethod
    def from_runtime(cls, runtime) -> "FleetState":
        """Wrap a live :class:`~repro_torch.edge.runtime.EdgeRuntime`'s
        state (shared arrays, not copies — mutations are visible both
        ways)."""
        st = cls(runtime.channel, runtime.fleet)
        if runtime.busy:
            st.busy[sorted(runtime.busy)] = True
        return st

    # ------------------------------------------------------------------
    @property
    def population(self) -> int:
        return self.channel.num_clients

    @property
    def snr_round(self) -> np.ndarray:
        """(N,) this round's effective per-client SNR (post-fading)."""
        return self.channel._snr_round

    @property
    def flops_per_s(self) -> np.ndarray:
        return self.fleet.flops_per_s

    @property
    def battery_j(self) -> np.ndarray:
        return self.fleet.battery_j

    def sample(self) -> None:
        """Re-draw this round's fading over the whole population (one
        vectorized rng call — the same stream the dict path consumes)."""
        self.channel.sample()

    def alive_mask(self) -> np.ndarray:
        """(N,) selectable clients: battery left and not in flight."""
        return (self.fleet.battery_j > 0.0) & ~self.busy

    def spend(self, clients, joules) -> None:
        self.fleet.spend(clients, joules)
