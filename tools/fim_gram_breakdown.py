#!/usr/bin/env python3
"""The Fisher-diagonal and Gram kernels' time on one NVIDIA GPU, for one
version of the port, and the client and server steps around them.

    python3 tools/fim_gram_breakdown.py [--root TREE] [--label NAME] [--cuts]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout), so the
same script times another version of the port (e.g. an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory such as
``build/``) through the entry points both versions have.  Run it once a
version, in turns within one call (A, B, B, A): two calls may land on two
cards.

At the main path's shapes (the F-MNIST CNN's 8 leaves, d = 206,922), each
as device ms (ten calls queued behind a ~10 ms ``torch.cuda._sleep``, host
cost hidden) and call ms (one call from an idle device), medians of 21:

  * ``fim_client``: one client's Fisher diagonal at B = 600 as the
    version's ``core/fim.py`` computes it from the per-example gradients:
    ``ops.fim_diag_update_leaves`` (one launch) where the version has it,
    else a zero ``old``, ``.contiguous()`` and ``ops.fim_diag_update`` a
    leaf, as that version's ``_leaf_diag`` does;
  * ``fim_wide_leaf``: ``ops.fim_diag_update`` on the (600, 200,704) leaf;
  * ``gram_history``: ``core.lbfgs._gram_via_kernel`` on an m = 10 history
    of the CNN's leaves (the version's server-step Gram, any basis build
    included);
  * ``gram_basis``: ``ops.vlbfgs_gram`` on the materialised (21, 206,922)
    basis;

then, on the host clock (synchronised, medians of 7), the ``fim_lbfgs``
strategy's client step on 600 examples and its aggregate + server step
over 20 copies of that payload.  Every kernel result is checked against
the plain version.

``--cuts`` (this checkout's source only) also times, by text substitution
of ``csrc/vlbfgs.cu``, variants of the Gram kernel that stop early on the
m = 10 history (their outputs are wrong by design and are not checked):
``launch`` returns at once, ``copies`` streams the slabs without the
products, ``loop`` returns after the slabs and products, ``partials`` after
the block's partials (no reducers); each against the whole kernel, where
the differences say what each step costs.  ``compute`` runs the slab loop's
products on whatever shared memory holds, with no copies; ``copies8`` is
``copies`` with 8 shared-memory stages; ``stagesN`` is the whole kernel
with N stages in place of 4.

Prints the card's name and power limit, then one JSON line a row.  Exits 2
without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from _breakdown import build_cuts, print_card, time_ms

B, M, COHORT = 600, 10, 20
_STOP = "  if (s.n > 0) return;\n"
_RED = ("  float* red = smem;  // red[thread][kRedStride]: padded, so the stores "
        "do not conflict\n")
_ARRIVE = ("  if (threadIdx.x == 0) arrival = add_release(ticket, 1u);  // ... and "
           "published\n")
_STAGES = "constexpr int kStages = 4;"
# variant of csrc/vlbfgs.cu -> (text of the source, its replacement), in order
CUTS = {
    "launch": [("  const int l = leaf_of(t, blockIdx.x);\n",
                "  const int l = leaf_of(t, blockIdx.x);\n" + _STOP)],
    "copies": [("    if (my_tile < s.n_tiles) {\n", "    if (s.n < 0) {\n"),
               (_RED, _STOP + _RED)],
    "loop": [(_RED, _STOP + _RED)],
    "partials": [(_ARRIVE, _STOP + _ARRIVE)],
    "compute": [("    if (j < slabs) issue_slab(", "    if (s.n < 0) issue_slab("),
                ("    if (next < slabs)\n      issue_slab(",
                 "    if (s.n < 0)\n      issue_slab("),
                (_RED, _STOP + _RED)],
    "copies8": [("    if (my_tile < s.n_tiles) {\n", "    if (s.n < 0) {\n"),
                (_RED, _STOP + _RED),
                (_STAGES, _STAGES.replace("= 4;", "= 8;"))],
    # whole kernels with another number of shared-memory stages
    "stages3": [(_STAGES, _STAGES.replace("= 4;", "= 3;"))],
    "stages6": [(_STAGES, _STAGES.replace("= 4;", "= 6;"))],
    "stages8": [(_STAGES, _STAGES.replace("= 4;", "= 8;"))],
}


def host_s(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def gram_call(fn, vlbfgs, _build, s, y, g):
    """A call of one variant's entry on the history (s, y, g), as
    ``vlbfgs.gram_leaves`` makes it."""
    dev = g[0].device
    m = s[0].shape[0]
    n = 2 * m + 1
    cols = [x.numel() for x in g]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes, tile, chunk, first = vlbfgs.leaf_plan(n, cols, n_sm)
    partial = torch.empty((first[-1], n * (n + 1) // 2), device=dev)
    tickets = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty((n, n), device=dev)
    addrs = [p for a, b, c in zip(s, y, g)
             for p in (a.data_ptr(), b.data_ptr(), c.data_ptr())]
    args = ((ctypes.c_int64 * len(addrs))(*addrs),
            (ctypes.c_int64 * len(cols))(*cols),
            (ctypes.c_int * len(first))(*first), len(cols),
            (ctypes.c_int * 3)(m, m, 1), lanes, tile, chunk,
            partial.data_ptr(), tickets.data_ptr(), out.data_ptr())

    def call():
        _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                     "fim_gram_breakdown")
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1],
                        help="the checkout whose src/repro_torch to time")
    parser.add_argument("--label", default=None)
    parser.add_argument("--cuts", action="store_true",
                        help="time early-stopping variants of the Gram kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("fim_gram_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.configs.base import FedConfig
    from repro_torch.configs.paper_models import FMNIST_CNN
    from repro_torch.core import lbfgs
    from repro_torch.fed import strategies
    from repro_torch.kernels import _build, ops, ref, vlbfgs
    from repro_torch.models import cnn
    from repro_torch.utils.pytree import tree_leaves

    print_card()
    label = args.label or str(args.root)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(("fim_diag", "vlbfgs"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def emit(row):
        print(json.dumps({"tree": label, **row}), flush=True)

    def timed(row, fn):
        ms, call = time_ms(fn)
        emit({**row, "ms": ms, "call_ms": call})

    def close(got, want, tol, what, gram=False):
        """Within tol of the plain version: elementwise relative to the
        largest entry, a Gram entry to sqrt(want_ii want_jj)."""
        if gram:
            d = want.diagonal().sqrt()
            scale = torch.outer(d, d).clamp_min(torch.finfo(torch.float32).tiny)
        else:
            scale = max(float(want.abs().max()), 1.0)
        err = float(((got - want).abs() / scale).max())
        if err > tol:
            raise SystemExit(f"fim_gram_breakdown: {what} differs from the "
                             f"plain version by {err}")

    shapes = [tuple(p.shape) for p in tree_leaves(
        cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]
    grads = [torch.randn((B, *s), generator=gen, device=dev) for s in shapes]
    if hasattr(ops, "fim_diag_update_leaves"):
        def fim_client():
            mats = [g.reshape(B, -1).contiguous() for g in grads]
            return ops.fim_diag_update_leaves(mats, None, 0.0, mode="on")
    else:
        def fim_client():
            out = []
            for g in grads:
                g2 = g.reshape(B, -1)
                zeros = torch.zeros((g2.shape[1],), dtype=torch.float32,
                                    device=dev)
                out.append(ops.fim_diag_update(g2.contiguous(), zeros, 0.0,
                                               mode="on"))
            return out
    for got, g in zip(fim_client(), grads):
        close(got, ref.fim_diag_ref(g.reshape(B, -1),
                                    torch.zeros(got.shape, device=dev), 0.0),
              1e-5, "fim_client")
    timed({"row": "fim_client", "B": B, "leaves": len(shapes)}, fim_client)
    wide = grads[5].reshape(B, -1)
    zeros = torch.zeros((wide.shape[1],), device=dev)
    close(ops.fim_diag_update(wide, zeros, 0.0, mode="on"),
          ref.fim_diag_ref(wide, zeros, 0.0), 1e-5, "fim_wide_leaf")
    timed({"row": "fim_wide_leaf", "shape": list(wide.shape)},
          lambda: ops.fim_diag_update(wide, zeros, 0.0, mode="on"))

    s = [torch.randn((M, *sh), generator=gen, device=dev) * 1e-2
         for sh in shapes]
    y = [a * 1.5 for a in s]
    g = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    h = lbfgs.History(s=s, y=y,
                      idx=torch.zeros((), dtype=torch.int32, device=dev),
                      count=torch.full((), M, dtype=torch.int32, device=dev))
    basis = torch.cat([torch.cat([a.reshape(M, -1) for a in s], 1),
                       torch.cat([a.reshape(M, -1) for a in y], 1),
                       torch.cat([a.reshape(-1) for a in g])[None]])
    want = ref.vlbfgs_gram_ref(basis)
    close(lbfgs._gram_via_kernel(h, g, "on"), want, 1e-5, "gram_history",
          gram=True)
    close(ops.vlbfgs_gram(basis, mode="on"), want, 1e-5, "gram_basis",
          gram=True)
    timed({"row": "gram_history", "m": M, "shape": list(basis.shape)},
          lambda: lbfgs._gram_via_kernel(h, g, "on"))
    timed({"row": "gram_basis", "shape": list(basis.shape)},
          lambda: ops.vlbfgs_gram(basis, mode="on"))

    if args.cuts:
        row = {"row": "gram_cuts", "m": M, "shape": list(basis.shape)}
        entries = build_cuts(
            _build, "fim_gram_breakdown", "vlbfgs", CUTS, "vlbfgs_gram_leaves",
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int64]
            + [ctypes.c_void_p] * 4)
        for name, fn in entries.items():
            row[f"{name}_ms"] = time_ms(gram_call(fn, vlbfgs, _build, s, y,
                                                  g))[0]
        emit(row)

    strategy = strategies.get("fim_lbfgs")(
        FMNIST_CNN, FedConfig(num_clients=100, participation=0.2,
                              noniid_l=2, rounds=5, seed=0), 10, device=dev)
    xs = torch.randn((B, *FMNIST_CNN.input_shape), generator=gen, device=dev)
    ys = torch.randint(0, 10, (B,), generator=gen, device=dev)
    payload, _ = strategy.client_step((xs, ys), None)
    weights = torch.full((COHORT,), float(B), device=dev)
    snapshot = strategy.state_dict()

    def server():
        strategy.load_state_dict(snapshot)
        strategy.server_step(strategy.aggregate([payload] * COHORT, weights))

    emit({"row": "steps", "B": B, "cohort": COHORT,
          "client_step_s": host_s(lambda: strategy.client_step((xs, ys), None)),
          "aggregate_server_step_s": host_s(server)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
