"""The device an entry point runs on."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device of a run, a strategy or a model; CUDA must be present when asked
    for (no silent drop to the CPU).  Also pins f32 numerics: cuDNN runs
    f32 convolutions in TF32 by default (and matmuls may be allowed to),
    which keeps ~3 decimal digits and would break f32 parity with the
    reference."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device
