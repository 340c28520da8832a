"""Multi-pod dry run on ``torch.distributed`` (port of
``repro.launch.dryrun``): no card, no JAX.

For every (architecture x input shape x mesh) combination it builds the
port's real step (train = one federated FIM-L-BFGS round,
``launch/train.make_train_step(..., mesh=...)``; prefill = the
full-sequence forward; decode = one token against a cache) on the
production mesh of a ``fake`` process group of 256 or 512 ranks, with
every tensor a ``FakeTensor`` (shapes only), and records the following.
All combinations run in one process, each on its own process group and
mesh (``launch/mesh.make_mesh``: a record does not depend on what ran
before it).

  * ``argument_size_in_bytes``: the bytes one rank holds of the step's
    arguments (params, optimizer state, cache), from the local shard
    shapes of their rule tables (``param_bytes`` / ``opt_bytes`` /
    ``cache_bytes`` apart); ``fits_card`` compares it with the card's
    80 GB (activations not counted);
  * ``flops_global`` / ``flops_local`` and ``collectives`` (count and
    operand bytes by kind), from ``launch/cost.CostCounter``.

The step is run at 1 and 2 units of depth (layers; Jamba's 8-layer
periods) and, for train, 1 and 2 microbatch cohorts of the real cohort
size; since every layer and every cohort is the same computation, each
count is exactly affine in depth and in cohorts, and the record holds its
value at the full depth and cohort count (``extrapolated_from``), as the
reference's trip-count-weighted HLO costs do.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

Exits 1 when any combination errors, as the reference does.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import ASSIGNED, INPUT_SHAPES, ShapeConfig, get
from repro_torch.launch import cost as costlib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train as trainlib
from repro_torch.models import hybrid
from repro_torch.models import model as zoo
from repro_torch.models.layers import use_mesh
from repro_torch.utils import sharding as shd


def depth_unit(cfg) -> int:
    """Layers a unit of depth: Jamba's period, else one layer."""
    return hybrid.PERIOD if zoo.is_hybrid(cfg) else 1


def n_micro_for(cfg, shape: ShapeConfig, mesh, n_micro: int) -> int:
    """The reference's pinning: a cohort shards evenly over (pod, data)
    (one sequence a data shard at most), the arch's own count first."""
    sizes = shd.mesh_shape(mesh)
    data_shards = sizes.get("data", 1) * sizes.get("pod", 1)
    if cfg.train_n_micro:
        n_micro = cfg.train_n_micro
    return max(1, min(n_micro, shape.global_batch // data_shards))


def arg_bytes(cfg, shape: ShapeConfig, optimizer: str, mesh) -> dict:
    """Bytes one rank holds of the step's arguments at full size, from the
    meta shapes and the rule tables (params by ``param_rules``, optimizer
    state by ``OPT_RULES``, the cache by the defaults)."""
    rules = trainlib.param_rules(cfg)
    out = {}
    if shape.kind == "train":
        ocfg = trainlib.opt_config(cfg)
        p, ax, o, oax = trainlib.train_state_shapes(cfg, ocfg, optimizer)
        out["param_bytes"] = shd.shard_bytes(p, ax, mesh, rules)
        out["opt_bytes"] = shd.shard_bytes(o, oax, mesh, shd.OPT_RULES)
    else:
        p, ax = trainlib.abstract_params(cfg)
        out["param_bytes"] = shd.shard_bytes(p, ax, mesh, rules)
        if shape.kind == "decode":
            c, cax = trainlib.abstract_cache(cfg, shape.global_batch,
                                             shape.seq_len)
            out["cache_bytes"] = shd.shard_bytes(c, cax, mesh)
    out["argument_size_in_bytes"] = sum(out.values())
    return out


def _fake_inputs(cfg, shape: ShapeConfig, batch: int, mesh):
    """Fake-tensor inputs of the step, laid out on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor

    specs = zoo.input_specs(cfg, ShapeConfig(shape.name, shape.seq_len, batch,
                                             shape.kind))
    axes = zoo.input_axes(cfg, shape)
    return {k: distribute_tensor(
        torch.zeros(v.shape, dtype=v.dtype), mesh,
        shd.placements_for(v.shape, axes[k], mesh)) for k, v in specs.items()}


def _strided_shard_offsets_off_fake() -> None:
    """DTensor's ``_StridedShard.local_shard_size_and_offset`` (met where an
    op flattens a batch dim sharded over "data" with a head dim sharded
    over "model", as attention's batched matmuls do) reads shard offsets
    from an index tensor with ``.tolist()``, which a ``FakeTensorMode``
    refuses; run it on real tensors (it sizes shards, it does not touch
    the step's data)."""
    import functools

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types

    cls = placement_types._StridedShard
    orig = cls.local_shard_size_and_offset
    if getattr(orig, "_off_fake", False):
        return

    @functools.wraps(orig)
    def wrapped(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)
    wrapped._off_fake = True
    cls.local_shard_size_and_offset = wrapped


def run_step(cfg, shape: ShapeConfig, optimizer: str, mesh, n_micro: int,
             cohort: int) -> dict:
    """Build and run one step of ``cfg`` on fake tensors under the cost
    counter: ``n_micro`` cohorts of ``cohort`` sequences (train), or a
    batch of ``shape.global_batch``.  -> ``CostCounter.summary()``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    _strided_shard_offsets_off_fake()
    rules = trainlib.param_rules(cfg)
    with FakeTensorMode():
        params = zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        axes = zoo.param_axes(cfg)
        if shape.kind == "train":
            ocfg = trainlib.opt_config(cfg)
            opt = trainlib.fim_lbfgs.init(params, ocfg) if optimizer == \
                "fim_lbfgs" else (trainlib.baselines.adam_init(params)
                                  if optimizer == "fedavg_adam"
                                  else trainlib.baselines.sgd_init(params))
            params, opt = trainlib.shard_train_state(cfg, ocfg, params, opt,
                                                     mesh, optimizer)
            batch = zoo.input_specs(cfg, ShapeConfig(
                shape.name, shape.seq_len, n_micro * cohort, "train"))
            batch = trainlib.shard_batch(
                {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in batch.items()}, mesh, n_micro)
            step = trainlib.make_train_step(cfg, ocfg, n_micro=n_micro,
                                            optimizer=optimizer, mesh=mesh)
            with costlib.CostCounter() as counter:
                step(params, opt, batch)
            return counter.summary()
        params = shd.distribute_tree(params, axes, mesh, rules)
        inputs = _fake_inputs(cfg, shape, shape.global_batch, mesh)
        if shape.kind == "prefill":
            with costlib.CostCounter() as counter, use_mesh(mesh), \
                    implicit_replication(), torch.no_grad():
                trainlib.make_prefill_step(cfg)(params, inputs)
            return counter.summary()
        cache = shd.distribute_tree(
            zoo.init_cache(cfg, shape.global_batch, shape.seq_len,
                           device="cpu"), zoo.cache_axes(cfg), mesh)
        with costlib.CostCounter() as counter, use_mesh(mesh), \
                implicit_replication(), torch.no_grad():
            trainlib.make_serve_step(cfg)(params, cache, inputs["token"])
        return counter.summary()


def _affine(points: dict, at: tuple) -> dict:
    """Each number of ``points`` ({(units, cohorts): summary}) at ``at``,
    by the bilinear form c0 + cu·u + cm·m + cum·u·m through the four
    points (u, m in {1, 2}); with one cohort value, linear in u."""
    def value(get):
        if (1, 2) not in points:
            v1, v2 = get(points[(1, 1)]), get(points[(2, 1)])
            return v1 + (v2 - v1) * (at[0] - 1)
        v = {k: get(s) for k, s in points.items()}
        du_1 = v[(2, 1)] - v[(1, 1)]
        du_2 = v[(2, 2)] - v[(1, 2)]
        dm_1 = v[(1, 2)] - v[(1, 1)]
        cum = du_2 - du_1
        return (v[(1, 1)] + du_1 * (at[0] - 1) + dm_1 * (at[1] - 1)
                + cum * (at[0] - 1) * (at[1] - 1))

    kinds = sorted({k for s in points.values()
                    for k in s["collectives"]["count"]})
    count = {k: value(lambda s, k=k: s["collectives"]["count"].get(k, 0))
             for k in kinds}
    nbytes = {k: value(lambda s, k=k: s["collectives"]["bytes"].get(k, 0))
              for k in kinds}
    return {"flops_global": value(lambda s: s["flops_global"]),
            "flops_local": value(lambda s: s["flops_local"]),
            "collectives": {"count": count, "bytes": nbytes,
                            "total_bytes": sum(nbytes.values())}}


def run_one(arch: str, shape_name: str, multi_pod: bool,
            optimizer: str = "fim_lbfgs", n_micro: int = 16,
            cfg=None, shape: ShapeConfig | None = None) -> dict:
    """The record of one combination (``cfg``/``shape``: others than the
    registry's, e.g. a smoke config).  Needs the default process group to
    be a (fake) group of the mesh's size."""
    shape = shape or INPUT_SHAPES[shape_name]
    cfg = zoo.shape_variant(cfg or get(arch), shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "optimizer": optimizer, "family": cfg.family,
           "attn_variant": cfg.attn_variant}
    ok, reason = zoo.supports_shape(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
    t0 = time.time()
    unit = depth_unit(cfg)
    units = cfg.num_layers // unit
    if shape.kind == "train":
        nm = n_micro_for(cfg, shape, mesh, n_micro)
        rec["n_micro"] = nm
        cohort = shape.global_batch // nm
        grid = [(u, m) for u in (1, 2) for m in (1, 2)]
    else:
        nm, cohort, grid = 1, shape.global_batch, [(1, 1), (2, 1)]
    points = {(u, m): run_step(cfg.replace(num_layers=u * unit), shape,
                               optimizer, mesh, m, cohort) for u, m in grid}
    rec.update(_affine(points, (units, nm)))
    rec["extrapolated_from"] = {"layers": [unit, 2 * unit],
                                "n_micro": sorted({m for _, m in grid})}
    rec["build_s"] = round(time.time() - t0, 1)
    rec.update(arg_bytes(cfg, shape, optimizer, mesh))
    rec["fits_card"] = rec["argument_size_in_bytes"] < meshlib.HBM_BYTES
    rec["status"] = "ok"
    rec["n_params"] = int(cfg.param_count())
    rec["n_active_params"] = int(cfg.active_param_count())
    rec["tokens"] = shape.global_batch * (shape.seq_len
                                          if shape.kind != "decode" else 1)
    rec["kind"] = shape.kind
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--mesh", default="16x16",
                    choices=["16x16", "2x16x16", "both"])
    ap.add_argument("--optimizer", default="fim_lbfgs",
                    choices=list(trainlib.OPTIMIZERS))
    ap.add_argument("--n-micro", type=int, default=16)
    ap.add_argument("--out", default="experiments/dryrun_torch",
                    help="directory of the per-combination JSON records")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["16x16", "2x16x16"] if args.mesh == "both" else [args.mesh]
    combos = [(a, s, m) for m in meshes for a in archs for s in shapes]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape, mesh_name in combos:
        tag = f"{arch}_{shape}_{mesh_name}"
        if args.optimizer != "fim_lbfgs":
            tag += f"_{args.optimizer}"
        path = os.path.join(args.out, tag + ".json")
        rec = _record(arch, shape, mesh_name, args)
        failures += rec["status"] == "error"
        print(f"[dryrun] {tag}: {_line(rec)}", flush=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


def _record(arch: str, shape: str, mesh_name: str, args) -> dict:
    """One combination in this process, on its own fake process group;
    an exception is recorded, as the reference does."""
    import torch.distributed as dist

    multi_pod = mesh_name == "2x16x16"
    meshlib.fake_process_group(meshlib.mesh_size(multi_pod))
    try:
        return run_one(arch, shape, multi_pod, args.optimizer, args.n_micro)
    except Exception as e:  # noqa: BLE001 (record, go on)
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}"}
    finally:
        dist.destroy_process_group()


def _line(rec: dict) -> str:
    if rec["status"] != "ok":
        return rec["status"] + " " + rec.get("reason", rec.get("error", ""))
    coll = rec["collectives"]
    return (f"{rec['argument_size_in_bytes'] / 1e9:.2f} GB a rank, "
            f"{rec['flops_global']:.4g} global FLOPs, collectives "
            f"{ {k: int(v) for k, v in coll['count'].items()} } "
            f"{coll['total_bytes'] / 1e9:.4g} GB, built in {rec['build_s']} s")


if __name__ == "__main__":
    raise SystemExit(main())
