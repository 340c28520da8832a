"""PyTorch/CUDA port of the federated FIM-L-BFGS system (``repro``).

Module names mirror ``src/repro/``; parameter trees keep the reference's
keys and layouts (HWIO conv weights, ``(in, out)`` dense weights, NHWC
inputs) and iterate leaves in sorted-key order, so the flat vector order
equals the reference's.  Hand-written Hopper kernels live in ``csrc/`` and
are dispatched by ``repro_torch.kernels.ops``.
"""
