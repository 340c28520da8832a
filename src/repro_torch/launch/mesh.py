"""Production mesh definitions (port of ``repro.launch.mesh``), on
``torch.distributed``.

Functions, not module-level constants: importing this module touches no
process group.  Each takes an initialised default process group whose
world size is the mesh's size: a real one (NCCL on the card, gloo on the
CPU), or the ``fake`` backend that ``launch/dryrun.py`` opens for 256 or
512 ranks in one process (``fake_process_group``).
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM5 data sheet, at the card's 700 W power limit
# (``nvidia-smi --query-gpu=name,power.limit``: "NVIDIA H100 80GB HBM3,
# 700.00 W" on the cards this repository was measured on): the dense bf16
# tensor-core rate, the HBM3 bandwidth, and the NVLink 4 bandwidth a GPU
# (18 links, both directions together).  These are the port's roofline
# inputs; the reference's TPU v5e constants do not apply to it.
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_FLOPS_BF16 = 989e12      # FLOP/s a card
HBM_BW = 3.35e12              # bytes/s a card
NVLINK_BW = 900e9             # bytes/s a card
HBM_BYTES = 80e9              # device memory a card

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def make_mesh(device_type: str, shape: tuple, axes: tuple):
    """A ``DeviceMesh`` over the default process group, flattened once.

    Two things DTensor keeps in the process would otherwise make a step's
    collectives depend on what ran before it:

    * its sharding-propagation cache is keyed by value, so an op whose
      inputs lie on a mesh equal to one of an earlier process group
      returns its output on that earlier mesh object, with the earlier
      group's communicators: the cache is cleared here;
    * it merges the per-dim all-reduces of a ``Partial`` on every dim
      into one collective only once a flattened mesh exists, and the
      server step's ``utils.sharding.mesh_all_reduce`` flattens it: made
      here, the first step issues the collectives of every later one."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache

    _clear_sharding_prop_cache()
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    if mesh.ndim > 1:
        mesh._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod; 2 pods = 512 ranks.

    Axes: "data" carries the federated client cohorts / global batch,
    "model" carries megatron + expert sharding, "pod" extends the cohort
    axis across pods."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(device_type, shape, axes)


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """A small ("data", "model") mesh over a process group of data x model
    ranks: on the cards unless the caller asks for ``device_type="cpu"``
    (a gloo group of CPU processes, as the tests make)."""
    return make_mesh(device_type, (data, model), ("data", "model"))


def fake_process_group(world_size: int, rank: int = 0) -> None:
    """Initialise the default process group on the ``fake`` backend: one
    process stands for rank ``rank`` of ``world_size``, and every
    collective returns at once without moving data (the dry run builds
    steps on it under ``FakeTensorMode``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def mesh_size(multi_pod: bool) -> int:
    return math.prod((MULTI_POD if multi_pod else SINGLE_POD)[0])
