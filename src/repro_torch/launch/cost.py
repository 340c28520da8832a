"""FLOP and collective counter of one step on a mesh (the port's
counterpart of ``repro.launch.hlo_cost``, which reads a compiled XLA
module; here the step runs eagerly, on fake tensors in the dry run).

``CostCounter`` stacks two dispatch modes around a call:

  * a FLOP mode over ``torch.utils.flop_counter``'s formulas (matmuls,
    attention, convolutions).  An op on DTensors is counted once at its
    GLOBAL shapes (``flops_global``: the work of the logical, unsharded
    op, whatever the ranks replicate or split of it; checked: a DTensor
    matmul on a 16 x 16 mesh counts 2·M·N·K of the whole product); an op
    on plain tensors is one rank's own work on its shards (inside
    ``local_map`` and the sharded server step: ``flops_local``).  Neither
    is divided by the rank count: a per-rank figure is not derived;
  * ``torch.distributed.tensor.debug.CommDebugMode``, which sees every
    collective DTensor issues and every functional collective of the
    port's own code; the counter adds each one's operand bytes (the local
    tensor this rank puts in), by kind.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the reference's collective kinds (hlo_cost.COLLECTIVES), by op name
KINDS = {"all_reduce": "all-reduce", "allreduce_": "all-reduce",
         "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_": "reduce-scatter",
         "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
         "broadcast": "broadcast", "broadcast_": "broadcast"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class _FlopMode(TorchDispatchMode):
    """FLOPs by ``FlopCounterMode``'s formulas, split into ops on DTensors
    (global shapes) and ops on plain tensors (local)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = {"global": 0, "local": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = self.registry.get(func._overloadpacket)
        if count is not None:
            key = "global" if any(issubclass(t, DTensor) for t in types) else "local"
            self.flops[key] += int(count(*args, **kwargs, out_val=out))
        return out


class CostCounter:
    """``with CostCounter() as c: step(...)``; then ``c.summary()``.
    ``flops=False`` counts the collectives only (the FLOP mode sees every
    op, which a timed run should not pay for)."""

    def __init__(self, flops: bool = True):
        from torch.distributed.tensor.debug import CommDebugMode

        counter = self

        class _Comms(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if out is not NotImplemented:
                    kind = KINDS.get(func._overloadpacket.__name__)
                    if kind is not None:
                        arg = args[0] if args else None
                        counter.count[kind] += 1
                        counter.bytes[kind] += _nbytes(arg)
                        if isinstance(arg, torch.Tensor):
                            counter.calls.append((kind, tuple(arg.shape),
                                                  arg.dtype))
                return out

        self.count: dict[str, int] = defaultdict(int)
        self.bytes: dict[str, int] = defaultdict(int)
        # (kind, operand shape, dtype) of each collective, in order
        self.calls: list[tuple] = []
        self._comms = _Comms()
        self._flops = _FlopMode() if flops else None

    def __enter__(self):
        self._comms.__enter__()
        if self._flops is not None:
            self._flops.__enter__()
        return self

    def __exit__(self, *exc):
        if self._flops is not None:
            self._flops.__exit__(*exc)
        self._comms.__exit__(*exc)
        return False

    def calls_of(self, kind: str, shape: tuple, dtype=None) -> int:
        """How many ``kind`` collectives took an operand of ``shape`` (and
        ``dtype``, when given)."""
        return sum(1 for k, s, d in self.calls if k == kind and s == shape
                   and (dtype is None or d == dtype))

    def summary(self) -> dict:
        """-> {"flops_global", "flops_local", "collectives": {"count",
        "bytes", "total_bytes"}} (the reference's ``collective_bytes``
        keys; bytes are each collective's operand bytes on this rank)."""
        flops = self._flops.flops if self._flops is not None else {}
        return {"flops_global": flops.get("global"),
                "flops_local": flops.get("local"),
                "collectives": {"count": dict(self.count),
                                "bytes": dict(self.bytes),
                                "total_bytes": sum(self.bytes.values())}}
