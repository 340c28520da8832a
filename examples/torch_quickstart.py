"""Quickstart on the PyTorch/CUDA port: train a federated classifier with
any registered strategy (default: the paper's FIM-L-BFGS, Algorithm 1)
under any upload codec; the counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py               # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
    PYTHONPATH=src python examples/torch_quickstart.py --full-width  # FMNIST_CNN
    PYTHONPATH=src python examples/torch_quickstart.py \\
        --algorithm fedavg_sgd --compress topk:0.1
"""
import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import FMNIST_CNN, reduced
from repro_torch.data.synthetic import make_classification
from repro_torch.fed import codecs, strategies
from repro_torch.fed.server import FederatedRun


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default: cuda)")
    ap.add_argument("--full-width", action="store_true",
                    help="the paper's F-MNIST CNN instead of reduced(...)")
    ap.add_argument("--algorithm", default="fim_lbfgs",
                    choices=strategies.names(),
                    help="federated strategy (default: fim_lbfgs)")
    ap.add_argument("--compress", default="none",
                    help=f"upload codec spec, one of {codecs.names()} with "
                         "an optional ':ratio' for topk/randk "
                         "(default: none)")
    args = ap.parse_args()

    mcfg = FMNIST_CNN if args.full_width else reduced(FMNIST_CNN)
    train, test = make_classification(mcfg, n_train=1500, n_test=400,
                                      seed=0, noise=1.2)
    fcfg = FedConfig(num_clients=20, participation=0.25, rounds=16,
                     noniid_l=3, compress=args.compress, seed=0)
    run = FederatedRun(mcfg, fcfg, train, test, args.algorithm,
                       device=args.device)
    print(f"== {args.algorithm} ({args.compress}) ==")
    run.run(rounds=16, eval_every=4, verbose=True)


if __name__ == "__main__":
    main()
