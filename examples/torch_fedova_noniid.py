"""FedOVA (Algorithm 2) vs FedAvg under pathological non-IID-2 on the
PyTorch/CUDA port: each client holds only two classes.  The Fig. 3
behaviour on the synthetic F-MNIST stand-in; the counterpart of
``examples/fedova_noniid.py``.

    PYTHONPATH=src python examples/torch_fedova_noniid.py               # CUDA
    PYTHONPATH=src python examples/torch_fedova_noniid.py --device cpu
"""
import argparse

from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import FMNIST_CNN, reduced
from repro_torch.data.synthetic import make_classification
from repro_torch.fed.server import FederatedRun


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the runs (default: cuda)")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()

    mcfg = reduced(FMNIST_CNN)
    train, test = make_classification(mcfg, n_train=1500, n_test=400,
                                      seed=0, noise=0.8)
    fcfg = FedConfig(num_clients=20, participation=0.25, local_epochs=2,
                     batch_size=16, rounds=args.rounds, noniid_l=2,
                     learning_rate=0.05, seed=0)
    results = {}
    for alg in ("fedavg_sgd", "fedova", "fedova_lbfgs"):
        run = FederatedRun(mcfg, fcfg, train, test, alg, device=args.device)
        print(f"== {alg} (each client sees only 2 of 10 classes) ==")
        hist = run.run(rounds=args.rounds, eval_every=4, verbose=True)
        results[alg] = max(h.get("accuracy", 0) for h in hist)
    print("\nbest accuracy:", results)


if __name__ == "__main__":
    main()
