"""Plain reference of the LLM federated train step: a dense decoder
(Granite, arXiv:2405.04324: RMSNorm, RoPE over the two halves of each
head, grouped-query causal attention, a SwiGLU MLP, an untied head) trained
by Algorithm 1 with microbatch cohorts as its clients.  Each cohort's
next-token loss and gradient, the server's mean gradient and mean squared
gradient (the microbatch Fisher), then the server step of
``reference/lbfgs.py`` over a history held in the configuration's dtype.
Plain PyTorch; imports nothing of the program.

Weights are stored in the configuration's dtype (bfloat16) and every
operation runs in float32 with TF32 off, one cohort at a time (the blocks
that keep it within the card).  ``precision="fp8"`` is the control: every
matmul's operands and every activation the program would store in
bfloat16 rounded to float8 (e4m3 forward, e5m2 for the matmuls' gradients,
one scale a tensor), one step below the configuration's bfloat16.
"""
from __future__ import annotations

import contextlib
import gc

import torch

from reference import lbfgs

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x: torch.Tensor, kind, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(kind).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a, torch.float8_e4m3fn, E4M3_MAX), _fp8(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g, torch.float8_e5m2, E5M2_MAX)
        return g8 @ b8.transpose(-1, -2), a8.transpose(-1, -2) @ g8


class Model:
    """The decoder's loss in float32 (or the fp8 control) over stored
    weights."""

    def __init__(self, cfg: dict, precision: str = "float32", q_chunk: int = 256):
        self.cfg = cfg
        self.fp8 = precision == "fp8"
        self.q_chunk = q_chunk

    def mm(self, a, b):
        return _Fp8Matmul.apply(a, b) if self.fp8 else a @ b

    def act(self, x):
        """An activation as the program stores it: rounded to fp8 in the
        control (gradients pass straight through), as is in float32."""
        if not self.fp8:
            return x
        return x + (_fp8(x, torch.float8_e4m3fn, E4M3_MAX) - x).detach()

    @staticmethod
    def norm(x, scale, eps: float):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale

    def rope(self, x, pos):
        hd = x.shape[-1]
        freqs = self.cfg["rope_theta"] ** (
            -torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = pos[:, None, None].float() * freqs
        cos, sin = torch.cos(ang), torch.sin(ang)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, q, k, v):
        """q (S, H, hd), k, v (S, KV, hd) -> (S, H * hd), causal, in query
        chunks against every key."""
        S, H, hd = q.shape
        G = H // k.shape[1]
        k = k.repeat_interleave(G, dim=1).transpose(0, 1)     # (H, S, hd)
        v = v.repeat_interleave(G, dim=1).transpose(0, 1)
        pos = torch.arange(S, device=q.device)
        outs = []
        for c in range(0, S, self.q_chunk):
            qc = q[c:c + self.q_chunk].transpose(0, 1) * hd ** -0.5   # (H, c, hd)
            scores = self.mm(qc, k.transpose(1, 2))
            mask = pos[c:c + self.q_chunk, None] >= pos[None, :]
            scores = scores.masked_fill(~mask, float("-inf"))
            outs.append(self.mm(torch.softmax(scores, dim=-1), v))
        return torch.cat(outs, dim=1).transpose(0, 1).reshape(S, H * hd)

    def loss(self, w: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy of one sequence (S,) over its first
        S - 1 positions; ``w`` holds float32 leaves that autograd tracks."""
        cfg = self.cfg
        eps = cfg["rms_norm_eps"]
        H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        S = tokens.shape[0]
        pos = torch.arange(S, device=tokens.device)
        act = self.act
        x = act(w["embed"][tokens.long()])
        lay = w["layers"]
        for i in range(cfg["num_hidden_layers"]):
            a = lay["attn"]
            z = act(self.norm(x, lay["ln1"][i], eps))
            q = act(self.rope(self.mm(z, a["wq"][i]).reshape(S, H, hd), pos))
            k = act(self.rope(self.mm(z, a["wk"][i]).reshape(S, KV, hd), pos))
            v = act(self.mm(z, a["wv"][i]).reshape(S, KV, hd))
            x = act(x + self.mm(act(self.attention(q, k, v)), a["wo"][i]))
            f = lay["ffn"]
            z = act(self.norm(x, lay["ln2"][i], eps))
            hid = act(self.mm(z, f["wi"][i]) * torch.nn.functional.silu(self.mm(z, f["wg"][i])))
            x = act(x + self.mm(hid, f["wo"][i]))
        h = act(self.norm(x, w["final_ln"], eps))
        logits = self.mm(h[:-1], w["head"])
        return torch.nn.functional.cross_entropy(logits, tokens[1:].long())


def leaves_of(tree: dict) -> list:
    """Leaves in sorted-key order (the program's tree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    return [tree]


def rebuild(tree: dict, leaves: list) -> dict:
    """``tree``'s structure over ``leaves`` (no nested closure: a recursive
    one is a reference cycle that would keep every cohort's float32 copy of
    the weights alive until the collector runs)."""
    return _rebuild(tree, iter(leaves))


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def run(cfg: dict, knobs: dict, params0: dict, batches: list, device,
        precision: str = "float32", fault: str | None = None) -> dict:
    """One train step a batch (B, S) from ``params0``, each batch cut into
    ``knobs["n_micro"]`` cohorts of consecutive rows; -> readings: each
    step's loss (the mean of its cohorts'), the first step's and the first
    Fisher diagonal's leaf norms, and each leaf's change after the last
    step.  ``fault``: "half_batch" averages the first half of the cohorts
    only; "answer" doubles the first step of the leaf it moves most."""
    with _f32():
        model = Model(cfg, precision)
        p0 = leaves_of(params0)
        server = lbfgs.Server(params=list(p0), knobs=_knobs(knobs))
        out: dict = {"loss": []}
        for step_no, batch in enumerate(batches):
            loss, gbar, fbar = _cohorts(model, params0, server.params, batch,
                                        knobs["n_micro"], fault)
            out["loss"].append(loss)
            alter = _double_largest if fault == "answer" and step_no == 0 else None
            step = server.step(gbar, fbar, alter)
            del gbar, fbar
            if step_no == 0:
                out["step1"] = lbfgs.leaf_norms(step)
                out["fisher1"] = lbfgs.leaf_norms(server.diag)
            del step
        out["change"] = lbfgs.leaf_norms(
            [a.float() - b.float() for a, b in zip(server.params, p0, strict=True)])
        return out


def follow(cfg: dict, knobs: dict, tree: dict, snap: dict, batch,
           precision: str = "float32", fault: str | None = None) -> dict:
    """One train step from a state the program reached: ``snap`` holds its
    parameters, Fisher diagonal and L-BFGS ring (leaves with a leading m
    dim, the next write slot ``idx`` and the live ``count``), in the
    program's tree order; none of them is written.  The ring is read
    oldest first by its index, the step taken as the reference takes it,
    its pair pushed.  -> the step's loss; the leaf norms of every live
    pair's s and y by age (0 the newest) and of each leaf's change.
    ``fault`` as :func:`run`'s, and "ring": a full history keeps its oldest
    pair and loses its newest."""
    m = knobs["lbfgs_m"]
    with _f32():
        model = Model(cfg, precision)
        params = list(snap["params"])
        ages = range(snap["count"] - 1, -1, -1)              # oldest first
        slots = [(snap["idx"] - 1 - a) % m for a in ages]
        pairs = [([s[k] for s in snap["s"]], [y[k] for y in snap["y"]]) for k in slots]
        server = lbfgs.Server(params=list(params), knobs=_knobs(knobs),
                              diag=[d.float() for d in snap["diag"]],
                              pairs=pairs, ring_fault=fault == "ring")
        loss, gbar, fbar = _cohorts(model, tree, params, batch, knobs["n_micro"], fault)
        server.step(gbar, fbar)
        del gbar, fbar
        newest = server.pairs[::-1]
        return {"loss": [loss],
                "s": [lbfgs.leaf_norms(s) for s, _ in newest],
                "y": [lbfgs.leaf_norms(y) for _, y in newest],
                "change": lbfgs.leaf_norms([a.float() - b.float() for a, b in
                                            zip(server.params, params, strict=True)])}


@contextlib.contextmanager
def _f32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        gc.collect()


def _knobs(knobs: dict) -> lbfgs.Knobs:
    return lbfgs.Knobs(learning_rate=knobs["learning_rate"], m=knobs["lbfgs_m"],
                       damping=knobs["fim_damping"], fim_ema=knobs["fim_ema"],
                       max_step_norm=knobs["max_step_norm"],
                       history_dtype=getattr(torch, knobs["history_dtype"]))


def _cohorts(model, tree, params, batch, n_micro, fault):
    """The batch's cohorts (consecutive rows) at ``params``: -> (mean loss,
    mean gradient, mean squared gradient), one cohort's graph at a time."""
    nm = min(n_micro, batch.shape[0])
    rows = batch.shape[0] // nm
    cohorts = list(range(nm))
    if fault == "half_batch":
        cohorts = cohorts[:max(1, nm // 2)]
    gsum = gsq = None
    total = 0.0
    for j in cohorts:
        live = [p.float().requires_grad_() for p in params]
        w = rebuild(tree, live)
        value = sum(model.loss(w, seq) for seq in batch[j * rows:(j + 1) * rows]) / rows
        grads = torch.autograd.grad(value, live)
        total += float(value.detach())
        del value, live, w      # the graph holds ``live`` until it goes
        if gsum is None:
            gsum = [g.clone() for g in grads]
            gsq = [g * g for g in grads]
        else:
            for a, q, g in zip(gsum, gsq, grads, strict=True):
                a.add_(g)
                q.addcmul_(g, g)
        del grads
    n = len(cohorts)
    return total / n, [a.div_(n) for a in gsum], [q.div_(n) for q in gsq]


def _double_largest(step: list) -> None:
    norms = lbfgs.leaf_norms(step)
    step[norms.index(max(norms))].mul_(2.0)
