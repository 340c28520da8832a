"""The port's sharded paths on real collectives: ONE launch of 4 gloo CPU
ranks on a (2, 2) ("data", "model") mesh, and one dry-run record on a
fake 16 x 16 mesh, each in subprocesses (no process group is ever made in
the pytest worker, which runs other files after this one).

On the 4 ranks (``WORKER``, which imports no JAX):
  * the sharded federated train step (``make_train_step(..., mesh=)``) of
    granite-8b's smoke config in f32 against the port's unsharded step, 2
    fim_lbfgs steps from the same init on the same batches (the unsharded
    step is held against the reference in tests/test_torch_train.py).
    Bounds: loss 1e-6 relative; each param leaf within 1e-5 of its norm;
    the Gram within GRAM_TOL = 1e-5 of sqrt(G_ii G_jj) entry by entry (as
    chip_smoke.py holds it); exactly one (2m+1)² f32 all-reduce a step for
    the Gram, and one plain Gram call a group of leaves that share a
    replication factor;
  * the expert-parallel MoE on dbrx's smoke config (4 experts on 2 model
    ranks) against the port's ``moe_apply`` on the whole batch and against
    ``repro.models.moe.moe_apply`` with no mesh, from the same numpy
    inputs: the output within 1e-5 of its norm, the dropped share exactly
    equal; and its gradients against the unsharded ones, 1e-5 of each
    leaf's norm (the router's through the output only: the EP aux is the
    reference's mean of per-shard aux, another number).
"""
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers to a machine, and
# torch's thread pools contend there (a small op can take 100 ms)
torch.set_num_threads(1)

from repro.configs import dbrx_132b as rdbrx  # noqa: E402
from repro.configs import granite_8b as rgranite  # noqa: E402
from repro.launch import train as rtrain  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.utils import sharding as rshd  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LOSS_TOL, LEAF_TOL, GRAM_TOL, MOE_TOL = 1e-6, 1e-5, 1e-5, 1e-5

WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.modules["jax"] = None           # the port's sharded paths need no JAX
import torch.distributed as dist
from repro_torch.configs import dbrx_132b, granite_8b
from repro_torch.data.synthetic import zipf_tokens
from repro_torch.kernels import ops
from repro_torch.launch import cost, mesh as meshlib, train
from repro_torch.models import moe
from repro_torch.models.layers import use_mesh
from repro_torch.utils import sharding as shd
from repro_torch.utils.pytree import tree_leaves

rank, out = int(os.environ["RANK"]), os.environ["OUT"]
dist.init_process_group("gloo", init_method=os.environ["INIT"], rank=rank,
                        world_size=int(os.environ["WORLD"]))
mesh = meshlib.make_debug_mesh(2, 2, device_type="cpu")
res = {}

# ---- the sharded train step against the unsharded one
cfg = granite_8b.smoke_config().replace(dtype="float32", lbfgs_dtype="float32")
ocfg = train.opt_config(cfg)
params, opt = train.init_train_state(cfg, ocfg, device="cpu")
sp, so = train.shard_train_state(cfg, ocfg, params, opt, mesh)
step = train.make_train_step(cfg, ocfg, n_micro=2, mesh=mesh)
ustep = train.make_train_step(cfg, ocfg, n_micro=2)
# every Gram, the unsharded step's too, goes through the sharded entry;
# the unsharded one with a LeafSum that has no mesh
grams, plain_calls = {"sharded": [], "plain": []}, [0]
sharded_gram, plain_leaves = ops.vlbfgs_gram_leaves_sharded, ops.vlbfgs_gram_leaves
def rec_gram(s, y, g, leaf_sum, **k):
    M = sharded_gram(s, y, g, leaf_sum, **k)
    grams["plain" if leaf_sum.mesh is None else "sharded"].append(M.tolist())
    return M
def count_plain(*a, **k):
    plain_calls[0] += 1; return plain_leaves(*a, **k)
ops.vlbfgs_gram_leaves_sharded = rec_gram
ops.vlbfgs_gram_leaves = count_plain
n = 2 * ocfg.m + 1
steps = []
for t in range(2):
    toks = torch.from_numpy(zipf_tokens(4, 32, cfg.vocab_size, seed=7 + t))
    plain_calls[0] = 0
    with cost.CostCounter() as c:
        sp, so, st = step(sp, so, train.shard_batch({"tokens": toks}, mesh, 2))
    sharded_calls = plain_calls[0]
    params, opt, ust = ustep(params, opt, {"tokens": toks})
    steps.append({"loss": [float(st["loss"]), float(ust["loss"])],
                  "dir_norm": [float(st["dir_norm"]), float(ust["dir_norm"])],
                  "gram_all_reduces": c.calls_of("all-reduce", (n, n),
                                                 torch.float32),
                  "plain_gram_calls": sharded_calls,
                  "unsharded_gram_calls": plain_calls[0] - sharded_calls,
                  "collective_kinds": sorted(c.count)})
res["steps"] = steps
res["groups"] = len(set(shd.LeafSum.for_tree(
    params, train.train_state_axes(cfg, ocfg)[0], mesh, shd.OPT_RULES).weights))
res["grams"] = grams
res["leaf_err"] = [float((a.full_tensor() - b).norm() / b.norm())
                   for a, b in zip(tree_leaves(sp), tree_leaves(params))]

# ---- the expert-parallel MoE against moe_apply on the whole batch
data = np.load(os.environ["MOE_IN"])
mcfg = dbrx_132b.smoke_config().replace(dtype="float32", capacity_factor=0.5)
p = {k: torch.from_numpy(data[k]) for k in ("router", "wi", "wg", "wo")}
x, w = torch.from_numpy(data["x"]), torch.from_numpy(data["w"])
live = {k: v.clone().requires_grad_() for k, v in p.items()}
out_u, (_, drop_u) = moe.moe_apply(live, mcfg, x)
g_u = torch.autograd.grad((out_u * w).sum(), list(live.values()))
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
dp = shd.distribute_tree(p, moe.moe_axes(), mesh)
dlive = {k: v.detach().requires_grad_() for k, v in dp.items()}
pl = shd.placements_for(x.shape, "batch,seq,embed", mesh)
with use_mesh(mesh), implicit_replication():
    out_s, (_, drop_s) = moe.moe_apply(dlive, mcfg, distribute_tensor(x, mesh, pl))
    g_s = torch.autograd.grad((out_s * distribute_tensor(w, mesh, pl)).sum(),
                              list(dlive.values()))
res["moe_drop"] = [float(drop_s.full_tensor()), float(drop_u)]
g_s, g_u = dict(zip(dlive, g_s)), dict(zip(live, g_u))
res["moe_grad_err"] = {k: float((g_s[k].full_tensor() - g_u[k]).norm()
                                / g_u[k].norm()) for k in g_u}
full = out_s.full_tensor().detach()
if rank == 0:
    np.savez(out + ".npz", sharded=full.numpy(), unsharded=out_u.detach().numpy())
    with open(out + ".json", "w") as f:
        json.dump(res, f)
dist.destroy_process_group()
'''

DRYRUN = r'''
import json, math, sys
import torch
torch.set_num_threads(1)
sys.modules["jax"] = None
from repro_torch.configs import granite_8b
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, mesh as meshlib, train
from repro_torch.utils import sharding as shd
meshlib.fake_process_group(256)
cfg = granite_8b.smoke_config().replace(dtype="float32", num_layers=3)
shape = ShapeConfig("smoke_train", 32, 32, "train")
rec = dryrun.run_one("granite-smoke", None, False, cfg=cfg, shape=shape)
# the record's counts extrapolate 1-2 layers and cohorts to 3 layers and
# its cohorts: the same numbers as running that step directly
mesh = meshlib.make_production_mesh(device_type="cpu")
direct = dryrun.run_step(cfg, shape, "fim_lbfgs", mesh, rec["n_micro"],
                         shape.global_batch // rec["n_micro"])
print(json.dumps({"rec": rec, "direct": direct}))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**kw):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), **kw}


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The 4 ranks' results: one launch for the module."""
    tmp = tmp_path_factory.mktemp("gloo")
    # capacity 0.5: picks drop, on both paths alike
    rcfg = rdbrx.smoke_config().replace(dtype="float32", capacity_factor=0.5)
    rp, _ = rmoe.moe_init(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(1)
    B, S = 4, 2 * rcfg.moe_group       # 4 groups: the EP gate holds
    x = rng.normal(size=(B, S, rcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    inputs = {**{k: np.asarray(v) for k, v in rp.items()}, "x": x, "w": w}
    np.savez(tmp / "moe_in.npz", **inputs)
    init = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER],
        env=_env(RANK=str(r), WORLD=str(WORLD), INIT=init,
                 OUT=str(tmp / "out"), MOE_IN=str(tmp / "moe_in.npz")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    res = json.loads((tmp / "out.json").read_text())
    res.update(np.load(tmp / "out.npz"))
    res["ref_out"], (_, ref_drop) = rmoe.moe_apply(rp, rcfg, jnp.asarray(x))
    res["ref_drop"] = float(ref_drop)
    return res


def test_sharded_train_step_matches_the_unsharded_step(gloo):
    for st in gloo["steps"]:
        got, want = st["loss"]
        assert abs(got - want) <= LOSS_TOL * abs(want)
        assert st["collective_kinds"]
    assert max(gloo["leaf_err"]) <= LEAF_TOL
    # both steps took a direction through the two-loop
    assert gloo["steps"][1]["dir_norm"][1] > 0


def test_sharded_gram_is_one_all_reduce_and_matches(gloo):
    """One (2m+1)² f32 all-reduce a step; the plain Gram runs once a
    replication group (the kernel launches once a group on the card); each
    entry within GRAM_TOL of sqrt(G_ii G_jj) of the unsharded Gram."""
    for st in gloo["steps"]:
        assert st["gram_all_reduces"] == 1
        assert st["plain_gram_calls"] == gloo["groups"] >= 2
        assert st["unsharded_gram_calls"] == 1
    assert len(gloo["grams"]["sharded"]) == len(gloo["grams"]["plain"]) == 2
    for got, want in zip(gloo["grams"]["sharded"], gloo["grams"]["plain"]):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        d = np.sqrt(np.outer(np.diag(want), np.diag(want)))
        assert (np.abs(got - want) <= GRAM_TOL * np.maximum(d, 1e-30)).all()
    # the second step's Gram holds the first step's pair
    assert np.abs(np.asarray(gloo["grams"]["plain"][1])).max() > 0


def test_expert_parallel_moe_matches_dense_and_reference(gloo):
    out, dense, ref = gloo["sharded"], gloo["unsharded"], np.asarray(gloo["ref_out"])
    for want in (dense, ref):
        assert np.linalg.norm(out - want) <= MOE_TOL * np.linalg.norm(want)
    assert gloo["moe_drop"][0] == gloo["moe_drop"][1] == gloo["ref_drop"] > 0
    for key in ("wi", "wg", "wo", "router"):
        assert gloo["moe_grad_err"][key] <= MOE_TOL, gloo["moe_grad_err"]


def _ref_rank_bytes(shapes, axes, mesh, rules) -> int:
    total = 0
    for s, a in zip(jax.tree.leaves(shapes), jax.tree.leaves(axes)):
        spec = rshd.spec_for(s.shape, a, mesh, rules)
        n = 1
        for dim, entry in zip(s.shape, spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= dim // math.prod(mesh.shape[m] for m in names)
        total += n * np.dtype(s.dtype).itemsize
    return total


class _Mesh:
    shape = {"data": 16, "model": 16}


def test_dryrun_record_on_a_fake_16x16_mesh():
    """A smoke config's train record on 256 fake ranks: its per-rank bytes
    are the arithmetic over the reference's specs, its collectives are
    there, and its depth/cohort extrapolation equals the direct run."""
    proc = subprocess.run([sys.executable, "-c", DRYRUN], capture_output=True,
                          text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rec, direct = out["rec"], out["direct"]
    assert rec["status"] == "ok" and rec["n_micro"] == 2
    rcfg = rgranite.smoke_config().replace(dtype="float32", num_layers=3)
    p, ax, o, oax = rtrain.train_state_shapes(rcfg, rtrain.opt_config(rcfg))
    assert rec["param_bytes"] == _ref_rank_bytes(p, ax, _Mesh, None)
    assert rec["opt_bytes"] == _ref_rank_bytes(o, oax, _Mesh, rshd.OPT_RULES)
    assert rec["argument_size_in_bytes"] == rec["param_bytes"] + rec["opt_bytes"]
    assert {"all-reduce", "reduce-scatter"} <= set(rec["collectives"]["count"])
    assert rec["flops_global"] == direct["flops_global"] > 0
    assert rec["flops_local"] == direct["flops_local"] > 0
    assert rec["collectives"] == direct["collectives"]
