"""Federated cohort simulation (port of ``repro.fed.simulator``).

server.py loops clients in Python (faithful to the paper's sequential
simulation).  This module is the *production* path: the selected
cohort's batches are stacked on a leading client dim, the whole cohort's
gradients and Fisher diagonals come from one batched call, and the
aggregation reduces over that dim once.

The reference vmaps its per-client jitted fn over the cohort.
``torch.func.vmap`` cannot batch through the hand-written kernels (they
launch through ctypes), so here the cohort client fn is built batched
(``fed.client.make_cohort_grad_fim_fn``): a vmap over K of the gradient,
a vmap over K and B of the per-example gradients, and Γ of every slot in
one fused call outside the vmap (on the card: one ``fim_diag`` launch a
64 (slot, leaf) matrices).  The round runs eagerly on the params' device.

``from_strategy`` derives the whole round step from a registered
strategy object (its cohort client fn and pure server update), so the
Python-loop and cohort paths share their code.  Where the reference
takes a PRNG ``key``, the port takes a ``torch.Generator`` on the
payloads' device; ``None`` skips compression as ``key=None`` does."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import aggregation, fim_lbfgs
from repro_torch.edge.device import flops_grad_fim
from repro_torch.edge.runtime import EdgeRuntime
from repro_torch.fed import client as fed_client
from repro_torch.fed import codecs, comm
from repro_torch.utils.pytree import tree_leaves, tree_map


def _build_round_step(client_fn: Callable, server_update: Callable,
                      compress_fn: Optional[Callable] = None):
    """round_step(params, opt_state, cohort_batch, weights, generator=None):
    the cohort client fn over the stacked cohort, optionally each slot's
    (grad, Γ) payload round-tripped through the codec (``generator``
    supplies the randomness; None skips compression), one aggregation,
    the pure server update."""

    def round_step(params, opt_state, cohort_batch, weights, generator=None):
        grads, diags, losses = client_fn(params, cohort_batch)
        if compress_fn is not None and generator is not None:
            grads, diags = compress_fn((grads, diags), generator)
        w = torch.as_tensor(weights, dtype=torch.float32,
                            device=losses.device)
        grad = aggregation.weighted_mean(grads, w)      # Σ_k (n_k/n) ∇F_k
        diag = aggregation.weighted_mean(diags, w)      # Σ_k (n_k/n) Γ_k
        new_params, new_state, stats = server_update(
            opt_state, params, grad, diag)
        stats["loss"] = torch.mean(losses)
        return new_params, new_state, stats

    return round_step


def make_round_step(loss_fn: Callable, per_example_loss: Callable | None,
                    ocfg: fim_lbfgs.FimLbfgsConfig,
                    fim_mode: str = "per_example"):
    """Returns round_step(params, opt_state, cohort_batch, weights).

    cohort_batch: {"x": (K, B, ...), "y": (K, B)} — one stacked batch per
    selected client; weights: (K,) sample counts n_k.  ``ocfg.kernels``
    routes both Γ and the Gram through the kernels."""
    client_fn = fed_client.make_cohort_grad_fim_fn(
        loss_fn, per_example_loss, fim_mode, kernels=ocfg.kernels)

    def server_update(opt_state, params, grad, diag):
        return fim_lbfgs.update(opt_state, params, grad, diag, ocfg)

    return _build_round_step(client_fn, server_update)


def from_strategy(strategy):
    """Derive the cohort ``round_step`` from a registered strategy
    (repro_torch.fed.strategies): the strategy's own cohort client fn
    and pure server update, so the sequential and cohort paths share code.

    The strategy's codec (``FedConfig.compress``) is threaded through as
    well: pass a ``generator`` to the returned step and every slot's
    payload is round-tripped through ``strategy.compress_slots``
    (stateless — the cohort path keeps no per-client error-feedback
    residuals, so sparsifiers here quantify the raw, feedback-free
    compression error)."""
    try:
        client_fn = strategy.cohort_client_fn
        server_update = strategy.cohort_server_update
    except AttributeError as e:
        raise NotImplementedError(
            f"strategy {getattr(strategy, 'name', strategy)!r} does not "
            "expose a batched cohort path (needs cohort_client_fn + "
            "cohort_server_update)") from e
    compress_fn = None
    codec = getattr(strategy, "codec", codecs.NONE)
    if not codec.identity:
        def compress_fn(payload, generator):
            k = tree_leaves(payload)[0].shape[0]
            slots = [tree_map(lambda x, i=i: x[i], payload) for i in range(k)]
            received = strategy.compress_slots(slots, generator)
            return tree_map(lambda *t: torch.stack(t), *received)
    round_step = _build_round_step(client_fn, server_update, compress_fn)
    # advertise the wire format so with_edge bills the same codec the
    # payloads actually round-trip through — one spec, not two
    round_step.codec = codec
    return round_step


def with_edge(round_step: Callable, edge: EdgeRuntime, n_params: int,
              compress=None, tracer=None):
    """Wrap a cohort ``round_step`` with the edge cost model.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`) attaches
    observability to the given ``edge`` runtime — round/client spans on
    the simulated timeline, byte/energy/drop metrics — exactly as passing
    the tracer to ``EdgeRuntime(...)`` directly would; the kwarg exists
    so callers who received an already-built runtime can still trace it.

    The cohort is the selected client set; after the device-side step,
    the wrapper advances the edge clock by the synchronous-round wall
    time (per-client grad+FIM compute plus the 2d-float uplink under the
    configured topology) and drains batteries.  stats gains ``wall_s`` /
    ``sim_time_s`` / ``energy_j`` / ``dropped`` host-side entries (and
    ``barrier_s`` under a finite deadline).

    The wrapped step takes an optional ``clients`` array — the TRUE
    selected client ids — so device heterogeneity and battery drain hit
    the right fleet entries; without it, cohort slot i falls back to
    fleet entry i (mod fleet size).

    The uplink is costed at the codec's wire size, so edge time/energy
    shrink exactly as the ledger bytes do.  The codec is derived from the
    ``round_step`` itself (``from_strategy`` attaches the strategy's
    codec); ``compress`` exists only to state it explicitly and must
    match — billing a wire format the step does not round-trip raises,
    so cost and accuracy cannot be paired apart by accident.

    Each round the edge's AllocationPolicy apportions the shared
    bandwidth budget over the given cohort (``EdgeRuntime.allocate_for``
    — selection already happened upstream, only the ``allocate`` stage
    runs, and it runs BEFORE the device step so deadline enforcement can
    shape the aggregation).  Granted deadlines are enforced: a cohort
    slot whose device busts min(its grant, EdgeConfig.enforce_deadline_s)
    is cut off at the barrier — its weight is zeroed so the weighted_mean
    re-normalizes over the on-time partial cohort, and an all-dropped
    round applies no server step.  Policies that emit per-client
    *codecs* are rejected: the cohort path round-trips every client
    through the one run codec, and billing wire formats the payloads
    never saw is the divergence this layer exists to forbid."""
    if tracer is not None:
        edge.tracer = tracer
        if edge.async_agg is not None:
            edge.async_agg.tracer = tracer
    step_codec = getattr(round_step, "codec", codecs.NONE)
    codec = step_codec if compress is None else codecs.make(compress)
    if codec.spec() != step_codec.spec():
        raise ValueError(
            f"round_step round-trips payloads through "
            f"{step_codec.spec()!r} but billing was requested at "
            f"{codec.spec()!r}; build the step with the same codec "
            "(simulator.from_strategy attaches FedConfig.compress)")
    down_bytes = float(n_params * comm.BYTES_F32)

    def wire_fn(override=None):
        # grad+FIM payloads are summable: fully aggregatable on the wire
        return float((override or codec).wire_bytes(2.0 * n_params)), 0.0

    def edge_round_step(params, opt_state, cohort_batch, weights,
                        clients: Optional[np.ndarray] = None,
                        generator: Optional[torch.Generator] = None):
        if generator is None and not codec.identity:
            # billing compressed wire bytes for payloads that never
            # round-trip would pair uncompressed accuracy with compressed
            # cost — the silent divergence this layer exists to forbid
            raise ValueError(
                f"codec {codec.spec()!r} bills compressed uplink bytes: "
                "pass generator=... so the payloads actually round-trip "
                "through it (or build the step with compress='none')")
        k, b = cohort_batch["y"].shape[:2]
        if clients is None:
            cohort = np.arange(k) % edge.num_clients
        else:
            cohort = np.asarray(clients, dtype=int)
            if cohort.shape != (k,):
                raise ValueError(
                    f"clients must map each of the {k} cohort slots to a "
                    f"fleet entry, got shape {cohort.shape}")
            if cohort.size and (cohort.min() < 0
                                or cohort.max() >= edge.num_clients):
                raise ValueError(
                    f"client ids must be in [0, {edge.num_clients}), "
                    f"got range [{cohort.min()}, {cohort.max()}]")
        est, decision = edge.allocate_for(
            cohort, wire_fn, flops_grad_fim(n_params, b), codec=codec)
        if decision.heterogeneous_codecs:
            raise ValueError(
                f"allocation policy {edge.cfg.scheduler!r} assigns "
                "per-client upload codecs, but the cohort path "
                "round-trips every client through the one run codec — "
                "use FederatedRun for adaptive per-client wire formats")
        # deadline enforcement: a cohort slot whose device busted its
        # granted deadline contributes nothing — its weight is zeroed, so
        # weighted_mean re-normalizes over the on-time partial cohort
        # (an all-dropped round applies no server step at all)
        mask = None
        if decision.n_dropped:
            mask = np.asarray([float(int(cc) not in decision.dropped)
                               for cc in cohort], dtype=np.float32)
            w = torch.as_tensor(weights, dtype=torch.float32)
            weights = w * torch.from_numpy(mask).to(w.device)
        if mask is not None and not mask.any():
            new_params, new_state, stats = (
                params, opt_state, {"loss": float("nan")})
        else:
            # only forward the generator when given: a bare 4-arg
            # round_step stays valid
            args = (params, opt_state, cohort_batch, weights)
            new_params, new_state, stats = (
                round_step(*args) if generator is None
                else round_step(*args, generator))
        # duplicate cohort slots (mod fallback) share one subchannel but
        # carry one payload each — bill every slot
        uniq, counts = np.unique(cohort, return_counts=True)
        mult = {int(u): int(c) for u, c in zip(uniq, counts, strict=True)}
        up_arr = np.asarray([mult[int(i)] * wire_fn()[0]
                             for i in decision.selected])
        rec = edge.finish_round_sync(est, up_arr, down_bytes)
        stats = dict(stats)
        stats.update(wall_s=rec["wall_s"], sim_time_s=rec["clock_s"],
                     energy_j=rec["energy_j"], dropped=rec["dropped"])
        if "barrier_s" in rec:
            stats["barrier_s"] = rec["barrier_s"]
        return new_params, new_state, stats

    return edge_round_step
