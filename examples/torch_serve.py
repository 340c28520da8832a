"""Serve a model on the PyTorch/CUDA port: a prefill of Zipf prompts through
the flash-attention kernel, then batched greedy decode through the KV
cache (and the SSM state of Mamba-2 and Jamba); the counterpart of
``examples/serve.py``.

    PYTHONPATH=src python examples/torch_serve.py                  # CUDA
    PYTHONPATH=src python examples/torch_serve.py --device cpu
    PYTHONPATH=src python examples/torch_serve.py --arch qwen3-32b --tokens 64
    PYTHONPATH=src python examples/torch_serve.py --device cpu --arch jamba-v0.1-52b
    PYTHONPATH=src python examples/torch_serve.py --full-width     # granite-8b, ~17 GB
"""
import argparse
import importlib
import time

import torch

from repro_torch.configs import base
from repro_torch.data.synthetic import zipf_tokens
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import model as zoo

ARCH_MODULES = {"granite-8b": "granite_8b", "granite-20b": "granite_20b",
                "phi4-mini-3.8b": "phi4_mini", "qwen3-32b": "qwen3_32b",
                "chameleon-34b": "chameleon_34b",
                "qwen3-moe-235b-a22b": "qwen3_moe_235b",
                "dbrx-132b": "dbrx_132b", "jamba-v0.1-52b": "jamba_52b",
                "mamba2-370m": "mamba2_370m"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-8b", choices=sorted(ARCH_MODULES))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--full-width", action="store_true",
                    help="the published config instead of its smoke config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=32)
    args = ap.parse_args()

    cfg = (base.get(args.arch) if args.full_width else importlib.import_module(
        f"repro_torch.configs.{ARCH_MODULES[args.arch]}").smoke_config())
    device = torch.device(args.device)
    params = zoo.init(cfg, device=device)

    prompts = torch.from_numpy(zipf_tokens(args.batch, args.prompt_len,
                                           cfg.vocab_size, seed=0)).to(device)
    prefill = make_prefill_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": prompts})               # (B, 1, V)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"{args.arch} ({cfg.name}) prefill: {tuple(prompts.shape)} tokens in "
          f"{dt:.3f}s ({prompts.numel() / dt:.0f} tok/s on {device.type}); "
          f"next tokens {logits.argmax(-1)[:, 0].tolist()}")

    cache = zoo.init_cache(cfg, batch=args.batch, context=args.tokens + 8,
                           device=device)
    step = make_serve_step(cfg)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=device)
    out = []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        logits, cache = step(params, cache, tok)                # (B, 1, V)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)      # greedy (B, 1)
        out.append(tok[:, 0])
    _sync(device)
    dt = time.perf_counter() - t0
    gen = torch.stack(out, dim=1)
    print(f"{args.arch} ({cfg.name}) decode: generated {tuple(gen.shape)} tokens "
          f"in {dt:.2f}s ({args.batch * args.tokens / dt:.1f} tok/s on "
          f"{device.type})")
    print("sample:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
