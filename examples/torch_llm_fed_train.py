"""End-to-end driver on the PyTorch/CUDA port: federated FIM-L-BFGS
training of a reduced member of the granite-8b family on synthetic Zipf
token data, the LLM-scale train step of ``repro_torch.launch.train`` with
microbatch cohorts playing the client role; the counterpart of
``examples/llm_fed_train.py``.

    PYTHONPATH=src python examples/torch_llm_fed_train.py             # CUDA
    PYTHONPATH=src python examples/torch_llm_fed_train.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_llm_fed_train.py --optimizer fedavg_adam
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs.granite_8b import CONFIG
from repro_torch.data.synthetic import zipf_tokens
from repro_torch.launch import train as trainlib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--optimizer", default="fim_lbfgs",
                    choices=trainlib.OPTIMIZERS)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param variant (slow on a CPU)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_llm_ck.npz"))
    args = ap.parse_args()

    # reduced member of the granite family (exact arch, scaled dims);
    # --full gives the ~100M-param variant of the same stack.
    if args.full:
        cfg = CONFIG.replace(
            name="granite-100m", num_layers=12, d_model=768, num_heads=12,
            num_kv_heads=4, head_dim=64, d_ff=2304, vocab_size=16384,
            dtype="float32", remat=False, attn_q_chunk=64, lbfgs_m=10,
            lbfgs_dtype="float32")
    else:
        cfg = CONFIG.replace(
            name="granite-12m", num_layers=6, d_model=384, num_heads=6,
            num_kv_heads=2, head_dim=64, d_ff=1024, vocab_size=4096,
            dtype="float32", remat=False, attn_q_chunk=64, lbfgs_m=10,
            lbfgs_dtype="float32")
    print(f"arch {cfg.name}: {cfg.param_count() / 1e6:.1f}M params")

    device = torch.device(args.device)
    ocfg = trainlib.opt_config(cfg, learning_rate=0.3)
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt = trainlib.init_train_state(cfg, ocfg, gen, args.optimizer,
                                            device=device)
    step = trainlib.make_train_step(cfg, ocfg, n_micro=2,
                                    optimizer=args.optimizer)

    data = zipf_tokens(512, args.seq + 1, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for t in range(args.steps):
        idx = rng.integers(0, len(data), size=args.batch)
        batch = {"tokens": torch.from_numpy(data[idx, :args.seq]).to(device)}
        params, opt, stats = step(params, opt, batch)
        if (t + 1) % 20 == 0 or t + 1 == args.steps:
            norm = (f" |g| {float(stats['grad_norm']):.3f}"
                    if "grad_norm" in stats else "")
            print(f"step {t + 1:4d} loss {float(stats['loss']):.4f}{norm} "
                  f"({(time.time() - t0) / (t + 1):.2f}s/step)")
    checkpoint.save(args.ckpt, params)
    print(f"saved checkpoint to {args.ckpt}")


if __name__ == "__main__":
    main()
