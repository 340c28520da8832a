"""Buffered asynchronous aggregation with staleness-discounted weights.

Synchronous FEEL waits for the slowest selected client every round.  The
buffered-async alternative (FedBuff-style) dispatches the cohort, then
applies a server update as soon as ``buffer_size`` client results have
arrived — stragglers keep computing and land in a *later* buffer, their
contribution discounted by how many server versions elapsed while they
were in flight:

    w_i ∝ n_i · (1 + τ_i)^(-alpha),   Σ_i w_i = 1

with τ_i = server_version_now − version the client started from.  alpha=0
recovers plain sample-count weighting; large alpha suppresses very stale
updates.  Bytes are unchanged versus sync — every dispatched client still
uploads exactly once — only the round boundaries move, which is why the
``CommLedger`` must agree between the two paths for identical cohorts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from repro_torch.edge.events import EventClock


def staleness_weights(n_samples, staleness, alpha: float = 0.5) -> np.ndarray:
    """Normalized aggregation weights n_i·(1+τ_i)^(−alpha); sums to 1."""
    n = np.asarray(n_samples, dtype=np.float64)
    tau = np.asarray(staleness, dtype=np.float64)
    if n.size == 0:
        return np.zeros(0)
    w = n * np.power(1.0 + np.maximum(tau, 0.0), -float(alpha))
    s = w.sum()
    if s <= 0:
        return np.full(n.shape, 1.0 / n.size)
    return w / s


@dataclass
class _InFlight:
    client: int
    finish_time: float
    version: int          # server version the client computed against
    n_samples: float
    payload: Any


class AsyncAggregator:
    """Orders in-flight client results by completion time and flushes them
    in buffers of ``buffer_size``; tracks the server version for staleness.

    The caller dispatches work with ``submit`` (one per uploading client)
    and drains with ``pop_buffer``, which advances the shared clock to the
    arrival time of the last update in the buffer and returns the buffer
    with its staleness-discounted weights."""

    def __init__(self, clock: EventClock, buffer_size: int = 1,
                 alpha: float = 0.5, tracer=None):
        self.clock = clock
        self.buffer_size = max(1, int(buffer_size))
        self.alpha = float(alpha)
        self.version = 0
        # explicit counter: the shared clock may carry events other than
        # client completions, so len(clock) over-counts pending uploads
        self._in_flight = 0
        if tracer is None:
            from repro_torch.obs.trace import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer

    def submit(self, client: int, delay_s: float, n_samples: float,
               payload: Any) -> None:
        self.clock.push_after(
            delay_s, kind="client_done", client=int(client),
            payload=_InFlight(int(client), self.clock.now + float(delay_s),
                              self.version, float(n_samples), payload))
        self._in_flight += 1

    @property
    def in_flight(self) -> int:
        return self._in_flight

    def pop_buffer(self, size: Optional[int] = None) -> tuple[list, np.ndarray]:
        """Pop the next ``size`` completions (default buffer_size), advance
        the clock past them, bump the server version, and return
        (entries, weights) with weights summing to 1."""
        size = self.buffer_size if size is None else int(size)
        entries: list[_InFlight] = []
        while len(entries) < size:
            # stop once no completions remain in flight: the heap may
            # still hold other kinds (e.g. deadline-expiry markers for
            # dropped uploads) whose — possibly far-future — times must
            # not drag the clock forward when nothing is arriving
            if self._in_flight - len(entries) <= 0:
                break
            ev = self.clock.pop()
            if ev is None:
                break
            if ev.kind != "client_done":
                continue
            entries.append(ev.payload)
        self._in_flight -= len(entries)
        if not entries:
            return [], np.zeros(0)
        stale = [self.version - e.version for e in entries]
        w = staleness_weights([e.n_samples for e in entries], stale, self.alpha)
        self.version += 1
        if self.tracer.enabled:
            from repro_torch.obs import trace as _t
            for e, tau in zip(entries, stale, strict=True):
                self.tracer.event(_t.LAND, _t.CAT_ASYNC, e.finish_time,
                                  client=e.client, staleness=int(tau),
                                  version=self.version)
                self.tracer.metrics.histogram("async_staleness").observe(tau)
        return entries, w
