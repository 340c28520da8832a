#!/usr/bin/env python3
"""The bf16 flash kernel under autograd on one NVIDIA GPU: the backward's
time beside its bound, the plain path's backward and the library's.

    python3 tools/flash_backward_breakdown.py [--ptxas]

At granite-8b's train step (B 1, H 32, KV 8, S 4,096, hd 128, causal; q, k
and v handed over as the model does, (B, S, heads, hd) transposed) and at
S 512: the backward's device and call ms (``flash_attention_backward``, two
launches), the forward under autograd (which also writes the f32 output and
the log-sum-exp) beside the prefill's forward, autograd's backward through
the plain chunked path (``models.attention._chunked_attention``), and
``scaled_dot_product_attention``'s backward as the library's yardstick (the
port never calls it).  Bounds: 8 * hd flops a live pair for the backward, 4
* hd for a forward, at 989 TFLOP/s.

``--ptxas`` first prints ptxas's registers, spills, stack and any
serialised-``wgmma`` warning of each kernel of ``csrc/flash_attention.cu``.
Prints the card's name and power limit, then one JSON line a row.  Exits 2
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from _breakdown import print_card, time_ms  # noqa: E402

from repro_torch.configs import granite_8b  # noqa: E402
from repro_torch.kernels import _build, flash_attention  # noqa: E402
from repro_torch.models import attention  # noqa: E402

PEAK = 989e12
SHAPES = {"granite-8b train, S 4096": (1, 32, 8, 4096, 128),
          "granite-8b train, S 512": (1, 32, 8, 512, 128)}


def ptxas_report() -> None:
    """Builds the library the wrapper loads (``-Xptxas -v`` only prints) and
    prints each kernel's lines of the report."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build._flags("flash_attention"), "-Xptxas", "-v",
           "-o", str(_build.library_path("flash_attention")),
           str(_build.CSRC / "flash_attention.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=900).stderr
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        if name and ("registers" in line or "spill" in line
                     or "wgmma" in line.lower()):
            print(json.dumps({"kernel": name, "ptxas": line.strip()}),
                  flush=True)


def inputs(B, H, KV, S, hd, seed=1):
    """bf16 q, k, v and dout as (B, S, heads, hd) tensors transposed."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, n, hd), generator=gen, device="cuda")
            .bfloat16().transpose(1, 2) for n in (H, KV, KV, H)]


def plain_backward(q, k, v, dout):
    """A call of autograd's backward through the chunked plain path."""
    cfg = granite_8b.CONFIG.replace(num_heads=q.shape[1],
                                    num_kv_heads=k.shape[1])
    ins = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    out = attention._chunked_attention(
        *ins, cfg, torch.arange(q.shape[2], device="cuda"), True)
    return lambda: torch.autograd.grad(out, ins, dout.transpose(1, 2),
                                       retain_graph=True)


def sdpa_backward(q, k, v, dout):
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(
        *ins, is_causal=True, enable_gqa=True)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ptxas", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_backward_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    print_card()
    if args.ptxas:
        ptxas_report()
    for label, (B, H, KV, S, hd) in SHAPES.items():
        q, k, v, dout = inputs(B, H, KV, S, hd)
        pairs = B * H * S * (S + 1) / 2
        _, o32, lse = flash_attention._forward(q, k, v, True, 0, save=True)
        row = {"shape": label, "B,H,KV,S,hd": [B, H, KV, S, hd],
               "causal": True,
               "bwd_bound_ms": 8 * hd * pairs / PEAK * 1e3,
               "fwd_bound_ms": 4 * hd * pairs / PEAK * 1e3}
        row["bwd_ms"], row["bwd_call_ms"] = time_ms(
            lambda: flash_attention.flash_attention_backward(
                q, k, v, o32, lse, dout, True, 0))
        row["fwd_saved_ms"], row["fwd_saved_call_ms"] = time_ms(
            lambda: flash_attention._forward(q, k, v, True, 0, save=True))
        row["fwd_prefill_ms"], row["fwd_prefill_call_ms"] = time_ms(
            lambda: flash_attention._forward(q, k, v, True, 0, save=False))
        row["plain_bwd_ms"], row["plain_bwd_call_ms"] = time_ms(
            plain_backward(q, k, v, dout), reps=5, per=3)
        row["sdpa_bwd_ms"], row["sdpa_bwd_call_ms"] = time_ms(
            sdpa_backward(q, k, v, dout), reps=11, per=5)
        print(json.dumps(row), flush=True)
        del o32, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
