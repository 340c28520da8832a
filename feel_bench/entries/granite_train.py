"""Entry: the LLM federated train step of ``repro_torch.launch.train.
make_train_step`` (Algorithm 1 over microbatch cohorts, the Gram through
the hand-written kernel), a closed loop of steps over a fixed pool of
Zipf-token batches.

Set-up draws the weights on the card from the seed, builds the step and its
optimizer state once, and drives its first three steps on distinct
batches; the same step, parameters and state then go to the window.  One
step is kept in flight: the host reads each step's loss after it has
issued the next.

The check has two stages.  The reference follows the first three steps
from the seed (``FROM_SEED``).  It cannot follow the window's steps that
way: the bf16 program and the f32 reference drift apart, and the L-BFGS
steps magnify the drift, so twelve steps from the seed read 0.004 to 0.6
apart on sound runs, as far apart as the control.  So once the window has
closed, :meth:`Entry.follow` takes the program one step further from the
state the window left (its ring full and wrapped: past m + 1 steps in all),
and keeps that state for the reference, which takes the same step from it:
the two-loop over the wrapped ring, the write into it, the clip and the
Fisher EMA.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from harness import datagen, roofline
from harness.trace import Clock, wrapped
from reference import granite as ref_granite
from reference import lbfgs as ref_lbfgs

FROM_SEED = 3        # steps the reference follows from the seed


class Entry:
    unit = "step"
    labels = ("server",)                # idle gaps by layer
    outside = "train step and model"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = config
        self.m = config["optimizer"]["lbfgs_m"]
        self.snapshot = None

    def arch(self):
        """The program's config: the registered architecture with the
        configuration file's depth (and, for a smoke rehearsal, widths)."""
        from repro_torch.configs.base import get

        m = self.model
        return get(self.cfg["arch"]).replace(
            num_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
            num_heads=m["num_attention_heads"],
            num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
            d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
            rope_theta=float(m["rope_theta"]), dtype=m["torch_dtype"],
            lbfgs_m=self.cfg["optimizer"]["lbfgs_m"],
            lbfgs_dtype=self.cfg["optimizer"]["history_dtype"],
            remat=self.cfg["remat"])

    def batch(self, i: int) -> torch.Tensor:
        t = self.traffic
        return datagen.zipf_tokens((t["batch"], t["seq_len"]),
                                   self.model["vocab_size"], self.seed, i,
                                   self.device)

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import fim_lbfgs
        from repro_torch.launch.train import make_train_step, opt_config

        clock = Clock()
        arch = self.arch()
        opt = self.cfg["optimizer"]
        ocfg = opt_config(arch, learning_rate=opt["learning_rate"])
        self.step_fn = make_train_step(arch, ocfg, n_micro=self.traffic["n_micro"],
                                       optimizer="fim_lbfgs", kernels="auto")
        params0 = datagen.lm_params(self.model, self.seed, self.device,
                                    getattr(torch, self.model["torch_dtype"]))
        self.state = fim_lbfgs.init(params0, ocfg)
        self.params = params0
        clock("weights and state")
        losses = []
        for i in range(FROM_SEED):
            self.params, self.state, stats = self.step_fn(
                self.params, self.state, {"tokens": self.batch(i)})
            losses.append(float(stats["loss"]))
            clock(f"checked step {i + 1}")
            if i == 0:
                step1 = ref_lbfgs.leaf_norms([s[0] for s in _leaves(self.state.history.s)])
                fisher1 = ref_lbfgs.leaf_norms(_leaves(self.state.fim.diag))
        change = ref_lbfgs.leaf_norms(
            [a.float() - b.float() for a, b in zip(_leaves(self.params),
                                                   _leaves(params0), strict=True)])
        del params0
        self.readings = {"loss": losses, "step1": step1, "fisher1": fisher1,
                         "change": change}
        self.steps = FROM_SEED
        self.pool = [self.batch(FROM_SEED + i) for i in range(self.traffic["pool"])]
        self.at = 0
        self.pending = None
        self.sync()

    # -- the window -----------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_unit(self) -> None:
        batch = {"tokens": self.pool[self.at % len(self.pool)]}
        self.at += 1
        self.steps += 1
        self.params, self.state, stats = self.step_fn(self.params, self.state, batch)
        if self.pending is not None:
            float(self.pending)           # the previous step's loss
        self.pending = stats["loss"]

    def finish(self) -> None:
        if self.pending is not None:
            float(self.pending)
            self.pending = None
        self.sync()

    def work(self) -> dict:
        t = self.traffic
        n = sum(x.numel() for x in _leaves(self.params))
        m = self.cfg["optimizer"]["lbfgs_m"]
        elt = 2 if self.cfg["optimizer"]["history_dtype"] == "bfloat16" else 4
        return {"tokens_per_unit": t["batch"] * t["seq_len"],
                "flops_per_unit": roofline.train_step_flops(self.model, t["batch"],
                                                            t["seq_len"]),
                "flops_peak": roofline.BF16_FLOPS_PER_S,
                "kernels": {"gram_leaves_kernel": roofline.gram_cost(m, n, elt)
                            + (roofline.F32_FLOPS_PER_S,)}}

    @contextlib.contextmanager
    def hooks(self, wrap):
        """``wrap(label, fn)`` around the server step, ``core.fim_lbfgs.update``,
        which the train step looks up at call time."""
        from repro_torch.core import fim_lbfgs

        with wrapped(fim_lbfgs, "update", lambda f: wrap("server", f)):
            yield

    # -- the check ------------------------------------------------------
    def follow(self) -> None:
        """After the window: steps on fresh batches until the ring has
        wrapped (m + 1 steps in all), then the followed step, with the
        state before it kept on the card for the reference (the slot the
        step overwrites and the Fisher diagonal, which it updates in place,
        copied; the ring restored once the step's readings are taken)."""
        fresh = FROM_SEED + self.traffic["pool"]
        while self.steps < self.m + 1:
            self.params, self.state, _ = self.step_fn(
                self.params, self.state, {"tokens": self.batch(fresh)})
            fresh += 1
            self.steps += 1
        hist = self.state.history
        idx, count = int(hist.idx), int(hist.count)
        slot_s = [s[idx].clone() for s in _leaves(hist.s)]
        slot_y = [y[idx].clone() for y in _leaves(hist.y)]
        diag = [d.clone() for d in _leaves(self.state.fim.diag)]
        params = self.params
        self.params, self.state, stats = self.step_fn(
            params, self.state, {"tokens": self.batch(fresh)})
        self.followed_batch = fresh
        hist = self.state.history
        ages = [(int(hist.idx) - 1 - a) % self.m for a in range(int(hist.count))]
        self.readings["wrap"] = {
            "loss": [float(stats["loss"])],
            "s": [ref_lbfgs.leaf_norms([s[k] for s in _leaves(hist.s)]) for k in ages],
            "y": [ref_lbfgs.leaf_norms([y[k] for y in _leaves(hist.y)]) for k in ages],
            "change": ref_lbfgs.leaf_norms(
                [a.float() - b.float() for a, b in zip(_leaves(self.params),
                                                       _leaves(params), strict=True)])}
        for bufs, olds in ((_leaves(hist.s), slot_s), (_leaves(hist.y), slot_y)):
            for buf, old in zip(bufs, olds, strict=True):
                buf[idx].copy_(old)
        self.snapshot = {"params": _leaves(params), "diag": diag, "s": _leaves(hist.s),
                         "y": _leaves(hist.y), "idx": idx, "count": count}
        self.sync()

    def release(self) -> None:
        """Free the program's state but what :meth:`follow` kept (a cycle
        may hold it: collect it)."""
        del self.params, self.state, self.pool, self.step_fn
        self.pending = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _knobs(self) -> dict:
        opt = self.cfg["optimizer"]
        return {"learning_rate": opt["learning_rate"], "lbfgs_m": opt["lbfgs_m"],
                "fim_damping": opt["fim_damping"], "fim_ema": opt["fim_ema"],
                "max_step_norm": opt["max_step_norm"],
                "history_dtype": opt["history_dtype"], "n_micro": self.traffic["n_micro"]}

    def reference_wrap(self, precision: str = "float32", fault=None) -> dict:
        """The reference's followed step from the state :meth:`follow` kept."""
        skeleton: dict = {}
        for path, _, _ in datagen.lm_param_shapes(self.model):
            node = skeleton
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = None
        return ref_granite.follow(self.model, self._knobs(), skeleton, self.snapshot,
                                  self.batch(self.followed_batch),
                                  precision=precision, fault=fault)

    def drop_snapshot(self) -> None:
        self.snapshot = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_seed(self, precision: str = "float32", fault=None) -> dict:
        """The reference's first ``FROM_SEED`` steps from the seed's weights."""
        params0 = datagen.lm_params(self.model, self.seed, self.device,
                                    getattr(torch, self.model["torch_dtype"]))
        return ref_granite.run(self.model, self._knobs(), params0,
                               [self.batch(i) for i in range(FROM_SEED)],
                               self.device, precision=precision, fault=fault)

    def reference(self, precision: str = "float32", fault=None) -> dict:
        """Both stages, the followed step first (its kept state then goes)."""
        wrap = self.reference_wrap(precision, fault)
        self.drop_snapshot()
        return {**self.reference_seed(precision, fault), "wrap": wrap}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
