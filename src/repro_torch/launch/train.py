"""LLM-scale step factories (port of ``repro.launch.train``): the
federated train step, its state, and the serving steps.

The train step is one *federated round* with the paper's Algorithm 1 as
its server step: microbatch cohorts (gradient accumulation) play the
client role, each computing a cohort gradient and its square (the
"microbatch" Fisher term of ``core/fim.py``); the accumulated means are
the server's ḡ and Γ̄, and ``core.fim_lbfgs.update`` takes the VL-BFGS
server step, its Gram matrix through the hand-written kernel on the card.
``optimizer="fedavg_sgd"|"fedavg_adam"`` swaps the server step for the
paper's baselines on the same data path (the Table II comparison at LLM
scale).

``make_train_step(..., mesh=...)`` is the same step on a ``DeviceMesh``:
parameters laid out by their logical axes (``PARAM_RULES_FSDP`` where
``cfg.fsdp``), the optimizer state by ``OPT_RULES`` (ZeRO-1), each
microbatch cohort sharded over ("pod", "data") (``shard_batch``).  Each
cohort's gradient reduces over the data axes into the state's layout (the
O(d) reductions of ḡ and Γ̄), and the server step runs on each rank's
shards with one (2m+1)² all-reduce for the Gram (Theorem 3's O(m²)
exchange) and scalar all-reduces for its norms.  The shape helpers
(``abstract_params``, ``train_state_shapes``, ``abstract_cache``) build
meta tensors for the dry run (``launch/dryrun.py``).

``make_train_step(..., tracer=obs.Tracer(wall=True))`` records the step's
spans (``train.step``; each ``train.cohort`` with its ``train.forward``,
``train.backward`` and ``train.accumulate``; ``train.means``; ``server``
with the server step's own spans inside): host intervals, profiler ranges
and, on the card, device time once the caller has synchronised and called
``tracer.resolve_device()``.  The default ``NULL_TRACER`` records nothing.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import baselines, fim_lbfgs
from repro_torch.models import model as zoo
from repro_torch.models.layers import use_mesh
from repro_torch.obs import NULL_TRACER
from repro_torch.utils import sharding as shd
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

OPTIMIZERS = ("fim_lbfgs", "fedavg_adam", "fedavg_sgd")


def opt_config(cfg: ArchConfig, learning_rate: float = 0.05
               ) -> fim_lbfgs.FimLbfgsConfig:
    return fim_lbfgs.FimLbfgsConfig(
        learning_rate=learning_rate,
        m=cfg.lbfgs_m,
        damping=1e-2,
        max_step_norm=1.0,
        history_dtype=getattr(torch, cfg.lbfgs_dtype),
        # LLM-scale configs keep the Fisher EMA / step temporaries in the
        # accumulation dtype
        state_dtype=getattr(torch, cfg.grad_accum_dtype),
    )


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got "
                         f"{optimizer!r}")


def make_train_step(cfg: ArchConfig, ocfg: fim_lbfgs.FimLbfgsConfig,
                    n_micro: int = 4, optimizer: str = "fim_lbfgs",
                    kernels: str = "auto", mesh=None, tracer=None):
    """(params, opt_state, batch) -> (params, opt_state, stats).

    ``mesh``: a ``DeviceMesh`` with axes among ("pod", "data", "model");
    the step then takes and returns the state laid out on it
    (``shard_train_state``) and the batch of ``shard_batch`` (``_OnMesh``
    says what changes; the step's body is the same).

    ``kernels`` is the step's kernel mode (``kernels.ops.resolve``), for
    the loss and the server step alike: under "auto" on the card each
    ``fim_lbfgs`` step launches the Gram kernel once, and a bf16 model's
    attention runs the flash kernel forward and backward
    (``models.attention.attn_apply``).  The step takes ``opt_state`` over: ``fim_lbfgs``
    updates its buffers in place (``fim_lbfgs.update(..., donate=True)``,
    the counterpart of the reference's donated state), so the caller
    passes the state it got back last time and keeps no other reference
    to it.  ``params`` are not written; the step returns new ones.

    ``tracer`` (``obs.NULL_TRACER`` when None): each call is one step of
    its host counter, its spans named as in the module docstring."""
    _check_optimizer(optimizer)
    ocfg = ocfg._replace(kernels=kernels)
    tracer = NULL_TRACER if tracer is None else tracer
    accum_dtype = getattr(torch, cfg.grad_accum_dtype)
    layout = (_OneDevice if mesh is None
              else functools.partial(_OnMesh, mesh, zoo.param_axes(cfg)))

    @torch.no_grad()
    def train_step(params, opt_state, batch):
        step = tracer.next_step()
        leaves = tree_leaves(params)
        with tracer.wall_span("train.step", round_id=step,
                              device=leaves[0].device):
            return _step(params, opt_state, batch, leaves, step)

    def _step(params, opt_state, batch, leaves, step):
        lay = layout(params)
        micro, nm = lay.cohorts(batch, n_micro)
        # the parameters in the optimizer state's layout (on a mesh a
        # local slice: no traffic), and the sums of the cohorts' gradient
        # and its square there, in the accumulation dtype
        p_state = [lay.to_state(p, i) for i, p in enumerate(leaves)]
        gsum = [torch.zeros_like(p, dtype=accum_dtype) for p in p_state]
        gsqsum = [torch.zeros_like(a) for a in gsum]
        lsum = None
        for j in range(nm):
            with tracer.wall_span("train.cohort", round_id=step, cohort=j):
                mb = tree_map(lambda x: x[j], micro)
                live = [p.detach().requires_grad_() for p in leaves]
                with torch.enable_grad(), lay.model_context():
                    with tracer.wall_span("train.forward", round_id=step):
                        loss, _ = zoo.loss_fn(tree_unflatten(params, live),
                                              cfg, mb, kernels)
                    with tracer.wall_span("train.backward", round_id=step):
                        grads = torch.autograd.grad(loss, live)
                with tracer.wall_span("train.accumulate", round_id=step):
                    loss = lay.replicate(loss.detach())
                    lsum = loss if lsum is None else lsum + loss
                    for i, (a, q, g) in enumerate(zip(gsum, gsqsum, grads,
                                                      strict=True)):
                        g = lay.to_state(g, i)  # on a mesh, the cohort's reduction
                        a.add_(g)
                        q.add_(torch.square(g.to(q.dtype)))
                del grads
        # the means, in place: ḡ and Γ̄ = the mean of the cohorts' g²
        with tracer.wall_span("train.means", round_id=step):
            for a in gsum + gsqsum:
                a.mul_(1.0 / nm)

        def local(xs):
            return tree_unflatten(params, [lay.local(x) for x in xs])

        state = tree_map(lay.local, opt_state)
        p_loc, grad, fim_diag = local(p_state), local(gsum), local(gsqsum)
        del gsum, gsqsum
        with tracer.wall_span("server", round_id=step):
            if optimizer == "fim_lbfgs":
                new_p, new_state, stats = fim_lbfgs.update(
                    state, p_loc, grad, fim_diag, ocfg, donate=True,
                    leaf_sum=lay.leaf_sum, tracer=tracer)
            elif optimizer == "fedavg_adam":
                new_p, new_state, stats = baselines.adam_update(
                    state, p_loc, grad, ocfg.learning_rate)
            else:
                new_p, new_state, stats = baselines.sgd_update(
                    state, p_loc, grad, ocfg.learning_rate)
        new_params = tree_unflatten(params, [
            lay.param_out(t, like, p) for t, like, p in zip(
                tree_leaves(new_p), p_state, leaves, strict=True)])
        stats = dict(stats)
        stats["loss"] = lay.local(lsum) / nm
        return new_params, lay.state_out(new_state, opt_state), stats

    return train_step


class _OneDevice:
    """The train step's layout hooks for a state held whole on one device:
    each the identity, the cohorts cut from the (B, ...) batch."""

    leaf_sum = None        # fim_lbfgs.update's default: LeafSum.local

    def __init__(self, params):
        del params

    def cohorts(self, batch, n_micro: int):
        """-> (the batch as (nm, B/nm, ...) cohorts of consecutive rows,
        nm = min(n_micro, B))."""
        B = tree_leaves(batch)[0].shape[0]
        nm = min(n_micro, B)
        return tree_map(lambda x: x.reshape((nm, B // nm) + x.shape[1:]),
                        batch), nm

    def model_context(self):
        return contextlib.nullcontext()

    def to_state(self, x, i: int):
        """Leaf ``i`` (a parameter or its gradient) in the optimizer
        state's layout."""
        return x

    def replicate(self, loss):
        return loss

    def local(self, x):
        """This rank's part of ``x``, for the server step."""
        return x

    def param_out(self, new, like, param):
        """A new parameter from the server step's ``new`` (laid out as
        ``like``) in the layout of ``param``."""
        return new

    def state_out(self, new_state, opt_state):
        """The server step's new state in the layout of ``opt_state``."""
        return new_state


class _OnMesh(_OneDevice):
    """The hooks on ``mesh`` (``make_train_step(..., mesh=)``): the batch
    comes cut into cohorts by ``shard_batch``; each cohort's loss and
    gradient run on DTensors (implicit replication for the plain tensors
    the model makes: positions, masks), its gradient is redistributed to
    the optimizer state's layout (a reduce-scatter where ZeRO-1 shards a
    dim over the data axes, an all-reduce elsewhere); the server step runs
    on the local shards with the state's ``LeafSum`` (one (2m+1)²
    all-reduce for the Gram, scalar ones for its norms), and the new
    parameters are gathered back to their own layout."""

    def __init__(self, mesh, axes, params):
        self.mesh = mesh
        self.opt_pl = []
        shd._leaves_map(lambda x, ax: self.opt_pl.append(shd.placements_for(
            x.shape, ax, mesh, shd.OPT_RULES)), params, axes)
        self.leaf_sum = shd.LeafSum.for_tree(params, axes, mesh,
                                             shd.OPT_RULES)

    def cohorts(self, batch, n_micro: int):
        return batch, tree_leaves(batch)[0].shape[0]

    def model_context(self):
        from torch.distributed.tensor.experimental import implicit_replication

        stack = contextlib.ExitStack()
        stack.enter_context(use_mesh(self.mesh))
        stack.enter_context(implicit_replication())
        return stack

    def to_state(self, x, i: int):
        return shd.to_placements(x, self.opt_pl[i])

    def replicate(self, loss):
        from torch.distributed.tensor import Replicate

        return shd.to_placements(loss, [Replicate()] * self.mesh.ndim)

    def local(self, x):
        return x.to_local()

    def param_out(self, new, like, param):
        return shd.to_placements(_from_local(new, like), param.placements)

    def state_out(self, new_state, opt_state):
        return tree_map(_from_local, new_state, opt_state)


def param_rules(cfg: ArchConfig):
    """The parameters' rule table: FSDP for the configs that ask for it."""
    return shd.PARAM_RULES_FSDP if cfg.fsdp else None


BATCH_AXES = {"tokens": "batch,seq", "labels": "batch,seq",
              "features": "batch,seq,embed", "mask": "batch,seq"}


def batch_placements(shape, key: str, mesh) -> list:
    """Placements of a micro-major (nm, B/nm, ...) batch leaf: each cohort
    sharded over ("pod", "data") on its batch dim (dim 1)."""
    spec = (None,) + shd.spec_for(shape[1:], BATCH_AXES[key], mesh)
    return shd.spec_placements(spec, mesh)


def shard_batch(batch: dict, mesh, n_micro: int) -> dict:
    """A (B, ...) batch (the same tensor on every rank) as the sharded
    step's input: cut into ``min(n_micro, B)`` microbatch cohorts of
    consecutive rows, as the unsharded step cuts it, each cohort's rows
    split over ("pod", "data"): DTensors (nm, B/nm, ...)."""
    out = {}
    for key, x in batch.items():
        B = x.shape[0]
        nm = min(n_micro, B)
        x = x.reshape((nm, B // nm) + tuple(x.shape[1:]))
        out[key] = shd.distribute(x, mesh, batch_placements(x.shape, key,
                                                            mesh))
    return out


def shard_train_state(cfg: ArchConfig, ocfg, params, opt_state, mesh,
                      optimizer: str = "fim_lbfgs"):
    """-> (params, opt_state) as DTensors on ``mesh``: each rank keeps its
    shard of the full trees it is given; params by their logical axes
    (``param_rules``), the optimizer state by ``OPT_RULES`` (ZeRO-1)."""
    axes, opt_axes = train_state_axes(cfg, ocfg, optimizer)
    return (shd.distribute_tree(params, axes, mesh, param_rules(cfg)),
            shd.distribute_tree(opt_state, opt_axes, mesh, shd.OPT_RULES))


def _from_local(local: torch.Tensor, like) -> torch.Tensor:
    """A local shard as a DTensor laid out as the DTensor ``like``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def make_prefill_step(cfg: ArchConfig, kernels: str = "auto"):
    """(params, batch) -> last-position logits; ``kernels`` is the
    attention's kernel mode."""
    def prefill_step(params, batch):
        return zoo.prefill_fn(params, cfg, batch, kernels=kernels)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, token) -> (logits, cache), one greedy-decode step."""
    def serve_step(params, cache, token):
        return zoo.decode_fn(params, cfg, cache, token)

    return serve_step


def init_train_state(cfg: ArchConfig, ocfg, generator: torch.Generator
                     | None = None, optimizer: str = "fim_lbfgs",
                     device="cuda"):
    """-> (params, opt_state) on ``device`` (the card unless the caller
    asks for the CPU); params drawn from ``generator`` (seed 0 when None).
    The reference also returns the sharding axes: ``train_state_axes``."""
    _check_optimizer(optimizer)
    params = zoo.init(cfg, generator, device=resolve_device(device))
    if optimizer == "fim_lbfgs":
        opt_state = fim_lbfgs.init(params, ocfg)
    elif optimizer == "fedavg_adam":
        opt_state = baselines.adam_init(params)
    else:
        opt_state = baselines.sgd_init(params)
    return params, opt_state


def train_state_axes(cfg: ArchConfig, ocfg, optimizer: str = "fim_lbfgs"):
    """-> (param axes, optimizer-state axes): what the reference's
    ``init_train_state`` returns beside the params and state."""
    _check_optimizer(optimizer)
    axes = zoo.param_axes(cfg)
    if optimizer == "fim_lbfgs":
        return axes, fim_lbfgs.state_axes(axes, ocfg)
    if optimizer == "fedavg_adam":
        return axes, baselines.adam_axes(axes)
    return axes, baselines.sgd_axes(axes)


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def abstract_params(cfg: ArchConfig):
    """(params on the meta device, axes tree) without allocating: the init
    runs on fake tensors (its draws cost nothing), then each leaf becomes a
    meta tensor of its shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = zoo.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return tree_map(_meta, fake), zoo.param_axes(cfg)


def train_state_shapes(cfg: ArchConfig, ocfg, optimizer: str = "fim_lbfgs"):
    """Meta (params, axes, opt_state, opt_axes) for the dry run."""
    params_s, _ = abstract_params(cfg)
    _check_optimizer(optimizer)
    if optimizer == "fim_lbfgs":
        opt_s = fim_lbfgs.init(params_s, ocfg)
    elif optimizer == "fedavg_adam":
        opt_s = baselines.adam_init(params_s)
    else:
        opt_s = baselines.sgd_init(params_s)
    axes, opt_axes = train_state_axes(cfg, ocfg, optimizer)
    return params_s, axes, opt_s, opt_axes


def abstract_cache(cfg: ArchConfig, batch: int, context: int):
    """(cache on the meta device, axes) for serve-step dry runs."""
    return (zoo.init_cache(cfg, batch, context, device="meta"),
            zoo.cache_axes(cfg))
