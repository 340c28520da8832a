#!/usr/bin/env python3
"""The codec kernels' time on one NVIDIA GPU, for one version of the port.

    python3 tools/codec_breakdown.py [--root TREE] [--label NAME] [--cuts]

Imports ``repro_torch`` from ``TREE/src`` (default: this checkout), so the
same script times another version of the port (e.g. an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory such as
``build/``) through the entry points both versions have.  Run it once a
version, in turns within one call (A, B, B, A): two calls may land on two
cards.

At the main path's shapes (the F-MNIST CNN, d = 206,922), each as device
ms (ten calls queued behind a ~10 ms ``torch.cuda._sleep``, host cost
hidden) and call ms (one call from an idle device), medians of 21:

  * ``topk_select`` through ``ops.topk_select(mode="on")`` at n = 413,844
    (fim_lbfgs's (g, Γ) payload), 206,922 (fedavg_sgd's delta) and 100,003,
    k = ceil(0.1 n); where the version has the one-launch cluster path,
    also each cluster size the card places and the four-launch path;
  * int8 on the 16 leaves of the (g, Γ) payload: the kernel path given
    the uniforms (the scale included), and ``Int8Codec.roundtrip`` whole
    (the uniforms' draws included);
  * ``TopKCodec("topk:0.1").roundtrip`` of the same payload with a
    residual (error feedback).

``--cuts`` (this checkout's source only) also times, by text substitution
of ``csrc/topk.cu``, variants of the one-launch kernel that stop early (their
outputs are wrong by design and are not checked): ``launch`` returns at once,
``copy`` after the chunk is in shared memory, ``hist`` after the histogram,
``push`` after it is stored into every other block through DSMEM and the
cluster barrier, ``threshold`` after t, need and the tie offset, ``count``
after the warps' tie counts, and ``nostore`` the whole kernel with (almost)
no store of out outside the one warp that walks its ties, ``nowalk`` the
whole kernel with that warp's walk left out; each against the
whole kernel, where the differences say what each step costs.

Prints the card's name and power limit, then one JSON line a row.  Exits 2
without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import torch

from _breakdown import build_cuts, print_card, time_ms

_STOP = "  if (n > 0) return;\n"
# variant of csrc/topk.cu -> (text of the source, its replacement), in order
CUTS = {
    "launch": [("  const int tid = threadIdx.x;\n",
                "  const int tid = threadIdx.x;\n" + _STOP)],
    "copy": [("".join(f"      atomicAdd(&hist[bucket_of(v.{c})], 1);\n"
                      for c in "xyzw"), ""),
             ("  __syncthreads();  // this chunk's histogram is complete\n",
              _STOP)],
    "hist": [("  __syncthreads();  // this chunk's histogram is complete\n",
              "  __syncthreads();  // this chunk's histogram is complete\n"
              + _STOP)],
    "push": [("  cluster.sync();  // every histogram has arrived; no DSMEM access "
              "after this\n",
              "  cluster.sync();  // every histogram has arrived; no DSMEM access "
              "after this\n" + _STOP)],
    "threshold": [("  const int t = sh_t;\n", _STOP + "  const int t = sh_t;\n")],
    "count": [("  int rank_t = sh_off;\n", _STOP + "  int rank_t = sh_off;\n")],
    "nowalk": [("  if (rank_t + warp_ties[warp] <= need || rank_t >= need) {\n",
                "  if (true) {\n")],
    "nostore": [("        out[lo + j0 + 32 * i] = (__float_as_uint(v[i]) & 0x7fffffffu) "
                 ">= keep_bits ? v[i] : 0.f;\n",
                 "        if (v[i] == 12345.f) out[lo + j0 + 32 * i] = v[i];\n")],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parents[1],
                        help="the checkout whose src/repro_torch to time")
    parser.add_argument("--label", default=None)
    parser.add_argument("--cuts", action="store_true",
                        help="time early-stopping variants of the cluster "
                             "kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("codec_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.configs.paper_models import FMNIST_CNN
    from repro_torch.fed import codecs
    from repro_torch.kernels import _build, codec_ops, ops, ref
    from repro_torch.models import cnn
    from repro_torch.utils.pytree import tree_leaves

    print_card()
    label = args.label or str(args.root)
    _build.build_all(("codec_ops", "topk"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def emit(row):
        print(json.dumps({"tree": label, **row}), flush=True)

    def timed(row, fn):
        ms, call = time_ms(fn)
        emit({**row, "ms": ms, "call_ms": call})

    cluster = hasattr(codec_ops, "topk_select_cluster")
    for n in (413_844, 206_922, 100_003):
        k = math.ceil(0.1 * n)
        half = n // 2
        x = torch.cat([torch.randn((half,), generator=gen, device=dev) * 1e-2,
                       torch.randn((n - half,), generator=gen, device=dev)
                       .square() * 1e-4])
        want = ref.topk_select_ref(x, k)
        paths = {"topk_select": lambda: ops.topk_select(x, k, mode="on")}
        if cluster:
            for c in (8, 16):
                placed, cap = codec_ops.cluster_shape(dev, c)
                if placed == c and n <= cap:
                    paths[f"topk_select_cluster{c}"] = (
                        lambda c=c: codec_ops.topk_select_cluster(x, k, c))
            paths["topk_select_tiles"] = lambda: codec_ops.topk_select_tiles(x, k)
        for name, fn in paths.items():
            if not torch.equal(fn().view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"codec_breakdown: {name} n={n} differs from "
                                 "the plain version")
            timed({"row": name, "n": n, "k": k}, fn)

    shapes = [tuple(p.shape) for p in tree_leaves(
        cnn.init(FMNIST_CNN, torch.Generator().manual_seed(0)))]
    xs = [torch.randn(s, generator=gen, device=dev) * 0.05 for s in shapes]
    xs += [torch.randn(s, generator=gen, device=dev).square() * 1e-4
           for s in shapes]
    us = [torch.rand(x.shape, generator=gen, device=dev) for x in xs]
    n = sum(x.numel() for x in xs)
    if hasattr(codec_ops, "int8_roundtrip_leaves"):
        def int8_kernel():
            return codec_ops.int8_roundtrip_leaves(xs, us)[0]
    else:
        def int8_kernel():
            return [codec_ops.int8_roundtrip(x, u, ref.int8_scale(x))
                    for x, u in zip(xs, us)]
    for got, x, u in zip(int8_kernel(), xs, us):
        if not torch.equal(got, ref.int8_roundtrip_ref(x, u)):
            raise SystemExit("codec_breakdown: the int8 kernel path differs "
                             "from the plain version")
    timed({"row": "int8_kernel_path", "leaves": len(xs), "n": n}, int8_kernel)
    keys = [f"leaf{i}" for i in range(len(xs))]
    payload = dict(zip(keys, xs))
    residual = dict(zip(keys, [x * 0.5 for x in xs]))
    int8, topk = codecs.make("int8"), codecs.make("topk:0.1")
    timed({"row": "int8_codec_roundtrip", "leaves": len(xs), "n": n},
          lambda: int8.roundtrip(payload, gen))
    timed({"row": "topk_codec_roundtrip", "leaves": len(xs), "n": n},
          lambda: topk.roundtrip(payload, gen, residual))

    if args.cuts:
        entries = build_cuts(
            _build, "codec_breakdown", "topk", CUTS, "topk_select_cluster",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_void_p])
        cluster, _ = codec_ops.cluster_shape(dev)
        for n in (413_844, 100_003):
            k = math.ceil(0.1 * n)
            x = torch.randn((n,), generator=gen, device=dev)
            out = torch.empty_like(x)
            row = {"row": "topk_cluster_cuts", "n": n, "k": k,
                   "cluster": cluster}
            for name, fn in entries.items():
                def call(fn=fn):
                    rc = fn(x.data_ptr(), out.data_ptr(), n, k, cluster,
                            torch.cuda.current_stream().cuda_stream)
                    _build.check(rc, "codec_breakdown")
                row[f"{name}_ms"] = time_ms(call)[0]
            emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
