#!/usr/bin/env python3
"""Where the bf16 tensor-core flash-attention kernel spends its time, on one
NVIDIA GPU.

    python3 tools/flash_breakdown.py [--baseline OTHER/flash_attention.cu]

Builds the kernel of ``src/repro_torch/csrc/flash_attention.cu`` and, by text
substitution of that source, timing-only variants that leave work out (their
outputs are wrong by design and are not checked):

  * ``no_p_lo``: P.V with P_hi alone (the cost of the hi/lo split's second
    product);
  * ``no_softmax``: no mask, max, exponent or rescale (S goes straight to the
    split);
  * ``gemm_only``: both left out: the two products and the split.

Each is timed with CUDA events, ten calls queued behind a ~10 ms
``torch.cuda._sleep`` (device time, host cost hidden), medians of 15, at
granite-8b's prefill shape, hubert-xlarge's, and granite's with a 1,024
window, beside ``scaled_dot_product_attention``.  Then the kernel alone at
hubert's shape with hd 64, 80 and 128: hd 80 is padded to 128 in shared
memory, so its P.V does the work of hd 128.  Prints the card's name and power
limit, then one JSON line a row.  Exits 2 without CUDA.

``--baseline`` builds another version of the source (e.g. an earlier
commit's, unpacked with ``git archive``) and times its bf16 entry point beside
the others, in the same process.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, flash_attention  # noqa: E402

OUT = _build.BUILD_DIR / "flash_breakdown"
SHAPES = {"granite-8b": (2, 32, 8, 4096, 128, True, 0),
          "hubert-xlarge": (2, 16, 16, 4096, 80, False, 0),
          "granite-8b, window 1024": (2, 32, 8, 4096, 128, True, 1024)}
# variant -> (text of the source, its replacement), applied in order
CUTS = {"no_p_lo": [("        wgmma_rs<HDP>(acc, p_lo[kk], dv);\n", "")],
        "no_softmax": [("    softmax(0);\n", ""), ("      softmax(t);\n", ""),
                       ("#pragma unroll\n      for (int i = 0; i < HDP / 2; "
                        "++i) acc[i] *= alpha[(i / 2) % 2];\n", "")]}
CUTS["gemm_only"] = CUTS["no_p_lo"] + CUTS["no_softmax"]


def build(variants: dict, baseline: Path | None) -> dict:
    """name -> the bf16 entry point of each variant's library (and of the
    baseline's), all compiled at once."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {name: (src, cuts) for name, cuts in variants.items()}
    if baseline is not None:
        sources["baseline"] = (baseline.read_text(), [])
    jobs = []
    for name, (text, cuts) in sources.items():
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"flash_breakdown: {name}: {old!r} is not "
                                 "once in the source")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build._flags("flash_attention"), "-o", str(so),
               str(cu)]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"flash_breakdown: building {name} failed:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_attention_bf16
        fn.argtypes = list(flash_attention._ARGS)
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def launcher(fn, q, k, v, causal: bool, window: int):
    """A call of ``fn`` as the wrapper makes it (same arguments)."""
    out = torch.empty_like(q)
    B, H, S, hd = q.shape
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (q, k, v, out)
                                      for i in range(3)))

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
                k.shape[1], S, hd, strides, int(causal), int(window),
                hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        _build.check(rc, "flash_breakdown")
    return call


def device_ms(fn, reps: int = 15, per: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def inputs(B, H, KV, S, hd):
    gen = torch.Generator(device="cuda").manual_seed(S + hd)
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for shape in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another flash_attention.cu to time beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    entries = build({"kernel": [], **CUTS}, args.baseline)
    for label, (B, H, KV, S, hd, causal, window) in SHAPES.items():
        q, k, v = inputs(B, H, KV, S, hd)
        row = {"shape": label, "B,H,KV,S,hd": [B, H, KV, S, hd],
               "causal": causal, "window": window}
        for name, fn in entries.items():
            row[f"{name}_ms"] = device_ms(launcher(fn, q, k, v, causal, window))
        mask = None
        if window:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] > i[:, None] - window) & (i[:, None] >= i[None, :])
        row["sdpa_ms"] = device_ms(functools.partial(
            torch.nn.functional.scaled_dot_product_attention, q, k, v,
            attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True))
        print(json.dumps(row), flush=True)
    B, H, KV, S, _, causal, window = SHAPES["hubert-xlarge"]
    row = {"shape": "hubert-xlarge by head dim (hd 80 padded to 128)"}
    for hd in (64, 80, 128):
        q, k, v = inputs(B, H, KV, S, hd)
        row[f"hd{hd}_ms"] = device_ms(
            launcher(entries["kernel"], q, k, v, causal, window))
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
