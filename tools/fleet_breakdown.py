#!/usr/bin/env python3
"""The fleet engine's device backend on one NVIDIA GPU, for one version of
the port: seconds a round and a widths call, beside the numpy backend.

    python3 tools/fleet_breakdown.py [--root TREE] [--label NAME] [--rounds N]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout), so the
same script times another version of the port (e.g. an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory such as
``build/``) through the entry points both versions have.  Run it once a
version, in turns within one call (A, B, B, A): two calls may land on two
cards.

``chip_smoke.py``'s fleet configuration (E1's channel with star
aggregation, 1e9 FLOP/s devices with a 50 J battery, the CNN's (g, Γ)
upload, 1 % of the population a round; energy_opt under a 60 s deadline
and a 40 s cut, bandwidth_opt uncut) at 10^5 and 10^6 clients, on the host
clock (a round and a call end in a read-back, so they wait for the
device):

  * ``jit_s`` / ``exact_s``: each backend's ``FleetEngine.run_round``,
    medians over ``--rounds`` rounds after one warm round (the host's
    noise shows in ``exact_s``, which runs no device code);
  * ``widths_s``: one ``bandwidth_opt_widths_jit`` / ``energy_opt_widths_jit``
    call on the card at the cohort's size, median of 51 calls after 3.

Each round's decisions are checked equal across the backends.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from _breakdown import print_card

POPULATIONS = (100_000, 1_000_000)
SHARE = 0.01
CNN_PARAMS = 206_922


def host_s(fn, reps: int = 51, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1],
                        help="the checkout whose src/repro_torch to time")
    parser.add_argument("--label", default=None)
    parser.add_argument("--rounds", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fleet_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.edge import (ChannelConfig, DeviceConfig, EdgeConfig,
                                  FleetEngine)
    from repro_torch.edge.device import flops_grad_fim
    from repro_torch.edge.fleet import kernel

    print_card()
    label = args.label or str(args.root)
    dev = torch.device("cuda")
    channel = ChannelConfig(bandwidth_hz=2e5, snr_db_mean=10.0,
                            snr_db_std=3.0, fading="rayleigh",
                            server_rate_bps=1.5e6, topology="star")
    devices = DeviceConfig(flops_per_s_mean=1e9, flops_per_s_sigma=1.2,
                           battery_j=50.0)
    d = CNN_PARAMS
    for pop in POPULATIONS:
        k = int(SHARE * pop)
        rng = np.random.default_rng(pop)
        bits = np.full(k, 64.0 * d)
        eff = np.log2(1.0 + 10.0 ** rng.uniform(0.2, 1.8, k))
        tc = np.exp(rng.uniform(np.log(0.5), np.log(40.0), k))
        c, w_min = rng.uniform(0.1, 2.0, k), rng.uniform(1e3, 1e5, k)
        feas = rng.uniform(size=k) < 0.9
        budget = channel.bandwidth_hz * k
        widths = {
            "bandwidth_opt": lambda: kernel.bandwidth_opt_widths_jit(
                bits, eff, tc, budget, device=dev),
            "energy_opt": lambda: kernel.energy_opt_widths_jit(
                c, w_min, feas, budget, device=dev),
        }
        for policy in ("bandwidth_opt", "energy_opt"):
            cut = 40.0 if policy == "energy_opt" else float("inf")
            cfg = EdgeConfig(channel=channel, device=devices, scheduler=policy,
                             deadline_s=60.0, enforce_deadline_s=cut,
                             min_clients=2)
            engines = {b: FleetEngine(cfg, pop, up_bytes=8.0 * d,
                                      flops=flops_grad_fim(d, 600),
                                      down_bytes=4.0 * d, seed=0, backend=b,
                                      device=dev)
                       for b in ("exact", "jit")}
            seconds = {b: [] for b in engines}
            for t in range(args.rounds + 1):
                recs = {}
                for b, eng in engines.items():
                    t0 = time.perf_counter()
                    recs[b] = eng.run_round(k)
                    if t:
                        seconds[b].append(time.perf_counter() - t0)
                if not np.array_equal(engines["exact"].last_decision.selected,
                                      engines["jit"].last_decision.selected) \
                        or recs["exact"]["dropped"] != recs["jit"]["dropped"]:
                    raise SystemExit(f"fleet_breakdown: {pop} {policy} round "
                                     f"{t}: the backends differ")
            print(json.dumps({
                "tree": label, "population": pop, "k": k, "policy": policy,
                "rounds": args.rounds,
                "jit_s": statistics.median(seconds["jit"]),
                "exact_s": statistics.median(seconds["exact"]),
                "jit_s_all": seconds["jit"],
                "widths_s": host_s(widths[policy])}), flush=True)
            del engines
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
