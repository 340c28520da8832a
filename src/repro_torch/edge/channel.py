"""Wireless channel model: Shannon-capacity links per client.

Each client k gets an uplink rate drawn per round,

    r_k = W · log2(1 + γ_k · h_k)

with W the allotted bandwidth (OFDMA subchannel — uplinks proceed in
parallel), γ_k the mean linear SNR of client k (lognormal shadowing across
the fleet, fixed per client), and h_k ~ Exp(1) optional per-round Rayleigh
fading power.  Transmission time for a payload of b bytes is 8b / r_k and
uplink energy is P_tx · t (the transmit-power model of arXiv:2104.05509
Sec. II; arXiv:1910.13067 uses the same capacity form for its resource
allocation).

Topologies (mirrors ``CommLedger``):
  * star — every selected client transmits its full payload to the server
    over its own subchannel; the round's comm phase ends when the slowest
    finishes.
  * tree — in-network aggregation along a binary tree of the selected
    clients: each node forwards ONE aggregated payload per level, so a
    round's comm time is depth × (slowest single hop), and the server link
    carries a single payload — Theorem 3's O(d log τ) reading.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ChannelConfig:
    bandwidth_hz: float = 1e6        # W — per-client uplink subchannel
    snr_db_mean: float = 10.0        # fleet-mean uplink SNR
    snr_db_std: float = 4.0          # lognormal shadowing across clients
    fading: str = "rayleigh"         # "none" | "rayleigh" (per-round Exp(1))
    tx_power_w: float = 0.5          # P_tx during uplink transmission
    downlink_rate_bps: float = 50e6  # base-station broadcast (fast, shared)
    server_rate_bps: float = 5e6     # base-station uplink slice: the SHARED
                                     # capacity every payload reaching the
                                     # server must cross (Theorem 3's O(k·d)
                                     # server-link term lives here)
    topology: str = "star"           # "star" | "tree"


def draw_snr_lin(cfg: ChannelConfig, num_clients: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Static per-client mean linear SNR (lognormal shadowing in dB) —
    the array-state constructor shared by :class:`Channel` and the fleet
    engine's ``FleetState`` (``repro_torch.edge.fleet``) (identical rng
    call, so both paths draw identical populations from the same seed)."""
    snr_db = rng.normal(cfg.snr_db_mean, cfg.snr_db_std, num_clients)
    return 10.0 ** (snr_db / 10.0)


def draw_snr_round(cfg: ChannelConfig, snr_lin: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """One round's effective per-client SNR: the static shadowing scaled
    by an Exp(1) Rayleigh fading power when configured (shared with the
    fleet engine — one draw per round over the whole population)."""
    if cfg.fading == "rayleigh":
        return snr_lin * rng.exponential(1.0, len(snr_lin))
    return snr_lin


class Channel:
    """Per-client link state; rates are re-drawn each round via ``sample``."""

    def __init__(self, cfg: ChannelConfig, num_clients: int, seed: int = 0):
        self.cfg = cfg
        self.num_clients = num_clients
        self._rng = np.random.default_rng(seed)
        # static per-client mean SNR (shadowing): lognormal in dB
        self._snr_lin = draw_snr_lin(cfg, num_clients, self._rng)
        self.rates_bps = self._draw_rates()

    def _draw_rates(self) -> np.ndarray:
        # this round's effective per-client SNR: set_bandwidth() re-derives
        # rates from it when an AllocationPolicy reapportions the budget
        self._snr_round = draw_snr_round(self.cfg, self._snr_lin, self._rng)
        return self.cfg.bandwidth_hz * np.log2(1.0 + self._snr_round)

    def sample(self) -> np.ndarray:
        """Re-draw fading for a new round; returns uplink rates (bit/s)
        at the nominal per-client subchannel ``cfg.bandwidth_hz``."""
        self.rates_bps = self._draw_rates()
        return self.rates_bps

    def scale_snr(self, factor) -> None:
        """Scale this round's effective linear SNR in place (scenario
        SNR-degradation faults, applied *after* allocation so the grant
        was provisioned against the clean draw); re-derives the nominal
        rates — callers re-apply :meth:`set_bandwidth` for granted
        widths.  The next ``sample()`` resets the draw."""
        self._snr_round = self._snr_round * np.asarray(factor, dtype=float)
        self.rates_bps = self.cfg.bandwidth_hz * np.log2(
            1.0 + self._snr_round)

    # ------------------------------------------------------------------
    def spectral_efficiency(self, clients) -> np.ndarray:
        """Per-client bits/s/Hz under this round's fading draw,
        log2(1 + γ_k·h_k) — the capacity form per unit bandwidth that a
        resource-allocation policy (arXiv:1910.13067) divides the budget
        against."""
        c = np.asarray(clients, dtype=int)
        return np.log2(1.0 + self._snr_round[c])

    def set_bandwidth(self, clients, bandwidth_hz) -> None:
        """Apply a RoundDecision's per-client subchannel widths for this
        round: rate_k = W_k · log2(1 + γ_k·h_k).  ``bandwidth_hz`` is a
        scalar (equal split) or an array aligned with ``clients``; the
        next ``sample()`` resets everyone to the nominal width."""
        c = np.asarray(clients, dtype=int)
        w = np.broadcast_to(np.asarray(bandwidth_hz, dtype=float), c.shape)
        self.rates_bps[c] = w * np.log2(1.0 + self._snr_round[c])

    def uplink_time_s(self, n_bytes, clients) -> np.ndarray:
        """Per-client transmission time; ``n_bytes`` is a scalar or an
        array aligned with ``clients`` (per-client codecs differ)."""
        c = np.asarray(clients, dtype=int)
        r = self.rates_bps[c]
        b = np.broadcast_to(np.asarray(n_bytes, dtype=float), c.shape)
        return 8.0 * b / np.maximum(r, 1e-6)

    def uplink_energy_j(self, n_bytes, clients) -> np.ndarray:
        return self.cfg.tx_power_w * self.uplink_time_s(n_bytes, clients)

    def downlink_time_s(self, n_bytes: float) -> float:
        """Broadcast time (one multicast payload on the shared downlink)."""
        return 8.0 * float(n_bytes) / max(self.cfg.downlink_rate_bps, 1e-6)

    # ------------------------------------------------------------------
    def comm_round_time_s(self, n_bytes: float, clients,
                          aggregatable: bool = True) -> float:
        """Wall time of the upload phase for the selected cohort.

        star: parallel subchannels -> max over clients.
        tree, aggregatable payloads (gradients/FIM — anything summed in-
        network): ceil(log2 k) levels, each bounded by the slowest hop; an
        aggregated payload is the same size as a client payload — the
        O(d log τ) reading of Theorem 3.
        tree, non-aggregatable payloads (FedAvg's k distinct local models):
        no in-network gain — the root link must carry every payload, so
        the bottleneck serializes k transfers on the best link (Theorem
        3's O(k·d) term survives the topology change)."""
        n_bytes = float(n_bytes)
        if aggregatable:
            return self.comm_round_time_split(n_bytes, 0.0, clients)
        return self.comm_round_time_split(0.0, n_bytes, clients)

    def comm_round_time_split(self, agg_bytes, nonagg_bytes,
                              clients) -> float:
        """Upload-phase wall time for a payload that is part aggregatable
        (summed in-network: gradients/FIM) and part not (distinct local
        models the server must see individually) — e.g. FedDANE's
        gradient + model phases.  Byte args are scalars or per-client
        arrays aligned with ``clients`` (heterogeneous upload codecs)."""
        clients = np.asarray(clients, dtype=int)
        k = clients.size
        if k == 0:
            return 0.0
        agg = np.broadcast_to(np.asarray(agg_bytes, dtype=float),
                              clients.shape)
        nonagg = np.broadcast_to(np.asarray(nonagg_bytes, dtype=float),
                                 clients.shape)
        total = agg + nonagg
        if total.sum() <= 0:
            return 0.0
        per = self.uplink_time_s(total, clients)
        srv = max(self.cfg.server_rate_bps, 1e-6)
        if self.cfg.topology == "tree":
            # aggregation parents are chosen among well-connected neighbours,
            # so a level costs a *representative* (median) hop, not the
            # fleet-worst deep fade.  Aggregatable bytes cross the server
            # link ONCE as a single summed payload — sized by the densest
            # contribution (O(d log τ)); non-aggregatable bytes cross it
            # once per client (Theorem 3's O(k·d) survives the topology
            # change).
            depth = max(1, math.ceil(math.log2(max(k, 2))))
            hops = depth * float(np.median(per))
            return hops + 8.0 * (float(agg.max()) + float(nonagg.sum())) / srv
        # star: subchannel air times in parallel, then every payload (both
        # classes) must cross the shared server slice
        return max(float(per.max()), 8.0 * float(total.sum()) / srv)
