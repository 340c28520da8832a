"""Resource-constrained FEEL demo on the PyTorch/CUDA port: the paper's
optimizer under a wireless edge with heterogeneous devices and non-IID-2
data (repro_torch.edge); the counterpart of ``examples/edge_noniid.py``.

Runs Algorithm 1 (fim_lbfgs) and FedAvg through the same constrained
uplink and prints simulated wall-clock and energy per round, then shows
what buffered-async aggregation, deadline scheduling, runtime-ENFORCED
deadlines (stragglers cut off at the barrier), and energy-optimal
bandwidth allocation buy when the fleet has stragglers.

    PYTHONPATH=src python examples/torch_edge_noniid.py              # CUDA
    PYTHONPATH=src python examples/torch_edge_noniid.py --device cpu
    # one named case, traced (Chrome trace + JSONL + metrics CSV):
    PYTHONPATH=src python examples/torch_edge_noniid.py --only enforced \\
        --trace-out trace_enforced

Tracing attaches a ``repro_torch.obs.Tracer`` to the run: round/client spans
on the simulated timeline, deadline verdicts, byte/energy metrics, and
the plan==ledger audit — exported as ``<trace-out>.json`` (load at
ui.perfetto.dev), ``<trace-out>.jsonl``, and ``<trace-out>_metrics.csv``.
"""
import argparse
import dataclasses

from repro_torch import obs
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import FMNIST_CNN, reduced
from repro_torch.data.synthetic import make_classification
from repro_torch.edge import ChannelConfig, DeviceConfig, EdgeConfig
from repro_torch.fed.server import FederatedRun

CHANNEL = ChannelConfig(bandwidth_hz=2e5, snr_db_mean=10.0, snr_db_std=3.0,
                        fading="rayleigh", server_rate_bps=1.5e6,
                        topology="tree")
FLEET = DeviceConfig(flops_per_s_mean=1e9, flops_per_s_sigma=1.2)


def run_one(mcfg, train, test, alg, edge, rounds=8, compress="none",
            tracer=None, device="cuda"):
    # second-order knobs pinned to the stabilized point (see
    # tests/test_fed_integration.py): partial cohorts make the aggregated
    # Fisher jump between rounds, so the Newton-type step needs the
    # tighter trust region
    fcfg = FedConfig(num_clients=16, participation=0.5, local_epochs=2,
                     batch_size=16, rounds=rounds, noniid_l=2,
                     learning_rate=0.05, seed=0, edge=edge,
                     compress=compress,
                     max_step_norm=0.5, fim_damping=0.05, fim_ema=0.9)
    run = FederatedRun(mcfg, fcfg, train, test, alg, tracer=tracer,
                       device=device)
    hist = run.run(rounds=rounds, eval_every=2, verbose=True)
    s = run.edge.summary()
    best = max(h.get("accuracy", 0) for h in hist)
    print(f"   -> best acc {best:.3f} in {s['wall_clock_s']:.1f} simulated "
          f"seconds, {s['energy_j']:.1f} J, {s['dropped_total']} excluded, "
          f"{s['deadline_dropped_total']} cut off at the deadline\n")
    if tracer is not None and tracer.enabled:
        tracer.audit.verify(run.ledger)
    return best, s


def demo_cases(mcfg, train, test, rounds, device="cuda"):
    """name -> zero-arg callable running that demo case (lazy, so --only
    builds and runs exactly one)."""
    star = dataclasses.replace(CHANNEL, topology="star")

    def case(alg, edge, compress="none", tracer=None):
        return lambda tr=None: run_one(mcfg, train, test, alg, edge,
                                       rounds=rounds, compress=compress,
                                       tracer=tr, device=device)

    return {
        "fim_lbfgs": case("fim_lbfgs", EdgeConfig(channel=CHANNEL,
                                                  device=FLEET)),
        "fedavg_sgd": case("fedavg_sgd", EdgeConfig(channel=CHANNEL,
                                                    device=FLEET)),
        "async": case("fedavg_sgd",
                      EdgeConfig(channel=CHANNEL, device=FLEET, mode="async",
                                 buffer_size=6, staleness_alpha=0.5)),
        "int8": case("fim_lbfgs", EdgeConfig(channel=CHANNEL, device=FLEET),
                     compress="int8"),
        "randk": case("fim_lbfgs", EdgeConfig(channel=CHANNEL, device=FLEET),
                      compress="randk:0.1"),
        "deadline": case("fedavg_sgd",
                         EdgeConfig(channel=CHANNEL, device=FLEET,
                                    scheduler="deadline", deadline_s=5.0,
                                    min_clients=3)),
        # bandwidth_opt minimizes the STAR barrier max_k(t_comp,k+t_up,k);
        # under tree aggregation the wall is depth x the median hop, a
        # different objective (see ROADMAP: tree-aware allocation is open)
        "star_uni": case("fim_lbfgs",
                         EdgeConfig(channel=star, device=FLEET,
                                    scheduler="uniform")),
        "bw_opt": case("fim_lbfgs",
                       EdgeConfig(channel=star, device=FLEET,
                                  scheduler="bandwidth_opt")),
        "adaptive": case("fedavg_sgd",
                         EdgeConfig(channel=CHANNEL, device=FLEET,
                                    scheduler="adaptive_codec",
                                    adaptive_ratio=0.25,
                                    adaptive_ratio_floor=0.05)),
        "energy_opt": case("fim_lbfgs",
                           EdgeConfig(channel=star, device=FLEET,
                                      scheduler="energy_opt",
                                      deadline_s=60.0, min_clients=2)),
        "enforced": case("fedavg_sgd",
                         EdgeConfig(channel=star, device=FLEET,
                                    scheduler="uniform",
                                    enforce_deadline_s=8.0)),
        "churn": case("fedavg_sgd",
                      EdgeConfig(channel=star, device=FLEET,
                                 scheduler="deadline", deadline_s=6.0,
                                 min_clients=3,
                                 scenario=("diurnal:period=8,amp=0.4,"
                                           "base=0.7,unit=round|"
                                           "snr_burst:prob=0.3,scale=0.1"),
                                 reallocate=True)),
    }


BLURBS = {
    "fim_lbfgs": "Algorithm 1 (fim_lbfgs), sync, tree aggregation",
    "fedavg_sgd": "fedavg_sgd, sync, tree aggregation",
    "async": ("fedavg_sgd, buffered async (stragglers land late, "
              "staleness-discounted)"),
    "int8": "fim_lbfgs + int8 codec (4x fewer uplink bytes -> time/energy)",
    "randk": "fim_lbfgs + rand-k 10% with error feedback (10x fewer bytes)",
    "deadline": ("fedavg_sgd, deadline policy (drop predicted stragglers; "
                 "survivors inherit their budget share)"),
    "star_uni": "fim_lbfgs, star, uniform split baseline",
    "bw_opt": ("fim_lbfgs, star, bandwidth_opt (same bytes, the sync "
               "barrier reshaped over the shared budget)"),
    "adaptive": ("fedavg_sgd, adaptive_codec (per-client top-k ratio from "
                 "the sampled channel rate)"),
    "energy_opt": ("fim_lbfgs, star, energy_opt (minimize sum energy s.t. "
                   "the deadline; same bytes as uniform, fewer joules)"),
    "enforced": ("fedavg_sgd, star, uniform + ENFORCED runtime deadline "
                 "(stragglers cut off at the barrier: partial uploads "
                 "billed, payloads discarded, on-time cohort aggregated)"),
    "churn": ("fedavg_sgd, star, diurnal churn + SNR bursts "
              "(repro_torch.edge.scenario) under the deadline policy, with "
              "mid-round re-allocation: a cut straggler's spectrum "
              "re-lands on the survivors still on the air"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None, metavar="CASE",
                    help="run one named demo case (default: all)")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default: cuda)")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="attach a Tracer and export <PREFIX>.json (Chrome "
                         "trace for Perfetto), <PREFIX>.jsonl, and "
                         "<PREFIX>_metrics.csv")
    args = ap.parse_args(argv)

    mcfg = reduced(FMNIST_CNN)
    train, test = make_classification(mcfg, n_train=1500, n_test=400,
                                      seed=0, noise=0.8)
    cases = demo_cases(mcfg, train, test, args.rounds, device=args.device)
    if args.only is not None and args.only not in cases:
        ap.error(f"unknown case {args.only!r}; known: {sorted(cases)}")
    names = [args.only] if args.only else list(cases)

    tracer = obs.Tracer() if args.trace_out else None
    print("== Algorithm 1 (fim_lbfgs) vs FedAvg over a constrained uplink ==")
    results = {}
    for name in names:
        print(f"-- {BLURBS[name]} --")
        results[name] = cases[name](tracer)

    if tracer is not None:
        chrome = obs.write_chrome(tracer, f"{args.trace_out}.json")
        jsonl = obs.write_jsonl(tracer, f"{args.trace_out}.jsonl")
        csv = obs.write_metrics_csv(tracer.metrics,
                                    f"{args.trace_out}_metrics.csv")
        print(f"trace: {chrome} (load at ui.perfetto.dev), {jsonl}, {csv}")

    print("summary (best_acc, sim_seconds):")
    for name, (best, s) in results.items():
        print(f"  {name:12s} acc {best:.3f}  t {s['wall_clock_s']:8.1f}s  "
              f"E {s['energy_j']:7.1f}J")


if __name__ == "__main__":
    main()
