#!/usr/bin/env python3
"""The sharded federated train step across cards: granite-8b at full width
(bf16, ``--layers`` of its 36, m = 10 bf16 history, 4 x 4,096 Zipf tokens
in 4 cohorts) on a (data, model) ``DeviceMesh`` of one NCCL process a card,
beside the unsharded step on card 0 from the same init and batch.

    python3 tools/sharded_step.py                    # 4 cards, 2 x 2
    python3 tools/sharded_step.py --data 4 --model 1
    python3 tools/sharded_step.py --device cpu --smoke --data 2 --model 2

Prints the card's name and power limit, then one JSON row a step of each
run: seconds (host clock ended by a sync on every rank), peak GB (the
largest over the ranks), and for the sharded run its collectives by kind
(count and operand bytes on rank 0, ``launch/cost.CostCounter``) and its
(2m+1)^2 f32 all-reduces; last the sharded run's loss and ``dir_norm``
relative to the unsharded one's and each param leaf's error relative to
its norm.  Tensor parallelism sums each matmul in another order, and the
unsharded step's attention runs the flash kernel where the mesh's runs the
plain chunked path, so the two runs are not expected to agree bit for bit.  ``--device cpu`` runs gloo
processes (a rehearsal; its seconds mean nothing).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import granite_8b  # noqa: E402
from repro_torch.data.synthetic import zipf_tokens  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.train import (init_train_state, make_train_step,  # noqa: E402
                                      opt_config, shard_batch,
                                      shard_train_state)
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

B, S, MICRO = 4, 4096, 4


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _steps(step, state, batch, steps, dev, counter=None):
    """-> (rows, last state, the last step's stats)."""
    rows = []
    for t in range(steps):
        _reset_peak(dev)
        _sync(dev)
        t0 = time.perf_counter()
        with counter if counter is not None and t == steps - 1 else _nullctx():
            params, opt, st = step(*state, batch)
        _sync(dev)
        rows.append({"step": t + 1, "seconds": time.perf_counter() - t0,
                     "loss": float(st["loss"]),
                     "dir_norm": float(st["dir_norm"]),
                     "peak_memory_GB": _peak_gb(dev)})
        state = (params, opt)
    return rows, state


class _nullctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def worker(rank: int, args, init: str, out: str) -> None:
    import torch.distributed as dist

    world = args.data * args.model
    dev = (torch.device("cuda", rank) if args.device == "cuda"
           else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world)
    cfg = (granite_8b.smoke_config().replace(num_layers=2) if args.smoke
           else granite_8b.CONFIG.replace(num_layers=args.layers))
    ocfg = opt_config(cfg)
    n = 2 * ocfg.m + 1
    seq = 64 if args.smoke else S
    toks = torch.from_numpy(zipf_tokens(B, seq, cfg.vocab_size, seed=3)).to(dev)

    def fresh():
        return init_train_state(cfg, ocfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)

    report = {}
    if rank == 0:   # the unsharded step on card 0, the others waiting
        rows, (params, opt) = _steps(make_train_step(cfg, ocfg, MICRO),
                                     fresh(), {"tokens": toks}, args.steps,
                                     dev)
        report["unsharded"] = rows
        want = [p.cpu() for p in tree_leaves(params)]
        del params, opt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_debug_mesh(args.data, args.model, device_type=dev.type)
    state = shard_train_state(cfg, ocfg, *fresh(), mesh)
    if dev.type == "cuda":
        torch.cuda.empty_cache()    # the full trees each rank drew
    counter = cost.CostCounter(flops=False)
    rows, (params, opt) = _steps(
        make_train_step(cfg, ocfg, MICRO, mesh=mesh), state,
        shard_batch({"tokens": toks}, mesh, MICRO), args.steps, dev, counter)
    peaks = [None] * world
    dist.all_gather_object(peaks, [r["peak_memory_GB"] for r in rows])
    full = [p.full_tensor().cpu() for p in tree_leaves(params)]
    if rank == 0:
        for i, r in enumerate(rows):
            r["peak_memory_GB"] = max(p[i] for p in peaks)
        report["sharded"] = rows
        report["collectives_last_step"] = {
            "count": dict(counter.count), "bytes": dict(counter.bytes),
            "gram_all_reduces": counter.calls_of("all-reduce", (n, n),
                                                 torch.float32)}
        u, s = report["unsharded"], rows
        report["rel"] = {
            "loss": [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                     for a, b in zip(s, u)],
            "dir_norm": [abs(a["dir_norm"] - b["dir_norm"]) / abs(b["dir_norm"])
                         for a, b in zip(s, u)],
            "max_leaf_err": max(float((a.float() - b.float()).norm()
                                      / max(float(b.float().norm()), 1e-30))
                                for a, b in zip(full, want))}
        report["mesh"] = {"data": args.data, "model": args.model}
        report["layers"] = cfg.num_layers
        with open(out, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="granite-8b's smoke config, 64-token sequences")
    args = ap.parse_args()
    world = args.data * args.model
    if args.device == "cuda":
        if torch.cuda.device_count() < world:
            print(f"sharded_step: needs {world} CUDA devices", file=sys.stderr)
            return 2
        from _breakdown import print_card
        print_card()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        init = f"tcp://localhost:{s.getsockname()[1]}"
    out = str(ROOT / "build" / "sharded_step.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    import torch.multiprocessing as mp
    mp.start_processes(worker, args=(args, init, out), nprocs=world,
                       start_method="spawn", join=True)
    with open(out) as f:
        report = json.load(f)
    for run in ("unsharded", "sharded"):
        for row in report[run]:
            print(json.dumps({"run": run, **row}), flush=True)
    print(json.dumps({k: report[k] for k in ("mesh", "layers",
                                             "collectives_last_step",
                                             "rel")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
