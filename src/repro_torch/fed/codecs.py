"""Pluggable upload-payload codecs (port of ``repro.fed.codecs``).

A codec answers two questions:

  * ``wire_bytes(n_floats)`` — the uplink bytes of an ``n_floats``-element
    payload, the single number CommLedger metering consumes, so
    "ledger == plan" holds under every codec;
  * ``roundtrip(tree, generator, residual)`` — what the server receives
    after encode+decode, and the residual the client keeps.

Registered here:

  * ``none``    — float32 passthrough (4 bytes/element);
  * ``int8``    — per-tensor symmetric int8 with stochastic rounding
    (1 byte/element), a whole payload through the CUDA kernel on CUDA
    tensors;
  * ``topk:r``  — keep the ``ceil(r·n)`` largest-magnitude coordinates of
    the flattened payload (the bucketed threshold select, through the
    CUDA kernel on CUDA tensors); 8 bytes per kept element (value +
    index);
  * ``randk:r`` — keep ``ceil(r·n)`` uniformly random coordinates; 4
    bytes per kept element (the server shares the index seed).

Both sparsifiers keep client-side **error feedback**: what a round drops
is returned as a residual, which FederatedRun keeps per client and adds
back into that client's next payload.  They need additive payloads, so
``FedStrategy.round_plan`` refuses them for plans that are not
``summable``.

    @register("fp16")
    class Fp16Codec(PayloadCodec):
        ...
"""
from __future__ import annotations

import abc
import math
from typing import Callable, Optional

import torch

from repro_torch.fed import comm
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.utils.pytree import (ravel, tree_leaves, tree_map,
                                      tree_unflatten)


class PayloadCodec(abc.ABC):
    """One upload wire format: byte accounting + the lossy round-trip.
    Codecs are stateless; per-client state (a residual) lives with the
    caller."""

    name: str = ""            # filled in by ``register``
    sparsifying: bool = False  # zeroes coordinates -> needs summable payloads
    error_feedback: bool = False  # returns a residual for the caller to keep
    # CUDA kernel knob for the encode loop ("auto" | "on" | "off", see
    # kernels.ops.resolve); ``make(spec, kernels=...)`` sets it per instance
    kernels: str = "auto"

    @property
    def identity(self) -> bool:
        """True if the round-trip is lossless passthrough (skip the work)."""
        return False

    @abc.abstractmethod
    def wire_bytes(self, n_floats: float) -> float:
        """Uplink bytes for an ``n_floats``-element payload."""

    @abc.abstractmethod
    def roundtrip(self, tree, generator: torch.Generator, residual=None):
        """-> (received_tree, new_residual); ``generator`` (on the
        payload's device) supplies any random draws; ``new_residual`` is
        the error-feedback state to hand back next round (None for
        residual-free codecs)."""

    def spec(self) -> str:
        """The ``FedConfig.compress`` string that reconstructs this codec."""
        return self.name

    def roundtrip_slots(self, trees, generator: torch.Generator) -> list:
        """What the server receives from each of a cohort's payloads, with
        no residual in or out (the vmapped cohort path, fed/simulator.py):
        ``roundtrip`` slot by slot, drawing from ``generator`` in slot
        order."""
        return [self.roundtrip(t, generator)[0] for t in trees]


class NoneCodec(PayloadCodec):
    """Uncompressed float32 uploads."""

    @property
    def identity(self) -> bool:
        return True

    def wire_bytes(self, n_floats: float) -> float:
        return float(n_floats) * comm.BYTES_F32

    def roundtrip(self, tree, generator, residual=None):
        return tree, None


def quantize_tree(tree, generator: torch.Generator):
    """-> (int8 tree, scales tree); unbiased stochastic rounding.  Draws
    one ``torch.rand`` per leaf in leaf order — the stream
    ``Int8Codec.roundtrip`` consumes, so the two agree bit for bit."""
    q_leaves, scales = [], []
    for leaf in tree_leaves(tree):
        u = kernel_ops.int8_uniforms(leaf, generator)
        scale = kernel_ref.int8_scale(leaf)
        q_leaves.append(kernel_ref.int8_quantize(leaf, u, scale).to(torch.int8))
        scales.append(scale)
    return tree_unflatten(tree, q_leaves), tree_unflatten(tree, scales)


def dequantize_tree(q_tree, scales):
    return tree_map(lambda q, s: q.float() * s, q_tree, scales)


class Int8Codec(PayloadCodec):
    """Per-tensor symmetric int8 with stochastic rounding: 4x fewer upload
    bytes, unbiased per round, no residual.  One ``torch.rand`` draw per
    leaf in leaf order; on CUDA tensors the whole payload goes through the
    CUDA kernel in one launch pair (``kernels.ops.int8_roundtrip_leaves``)."""

    def wire_bytes(self, n_floats: float) -> float:
        return float(n_floats) * comm.BYTES_INT8

    def roundtrip(self, tree, generator, residual=None):
        out = kernel_ops.int8_roundtrip_leaves(tree_leaves(tree), generator,
                                               mode=self.kernels)
        return tree_unflatten(tree, out), None

    def roundtrip_slots(self, trees, generator):
        # every slot's leaves in one call (on CUDA: one launch pair a 64
        # leaves); its uniforms are drawn leaf by leaf in slot order, the
        # stream of the slot-by-slot loop, so both agree bit for bit
        slots = [tree_leaves(t) for t in trees]
        out = kernel_ops.int8_roundtrip_leaves(
            [x for leaves in slots for x in leaves], generator,
            mode=self.kernels)
        received, at = [], 0
        for t, leaves in zip(trees, slots, strict=True):
            received.append(tree_unflatten(t, out[at:at + len(leaves)]))
            at += len(leaves)
        return received


class _SparsifyingCodec(PayloadCodec):
    """Ratio check and the error-feedback round-trip; subclasses pick the
    surviving coordinates (``_keep``).  Selection is global over the
    flattened payload (the leaf order of ``utils.pytree.ravel``), so
    exactly the ``ceil(ratio * n)`` coordinates ``wire_bytes`` bills
    cross the wire."""

    sparsifying = True
    error_feedback = True
    default_ratio = 0.1

    def __init__(self, ratio: Optional[float] = None):
        ratio = self.default_ratio if ratio is None else float(ratio)
        if not 0.0 < ratio <= 1.0:
            raise ValueError(
                f"codec {self.name or type(self).__name__!r} ratio must be "
                f"in (0, 1], got {ratio}")
        self.ratio = ratio

    def spec(self) -> str:
        return f"{self.name}:{self.ratio:g}"

    def _k(self, size: int) -> int:
        # an empty payload keeps 0 coordinates, matching wire_bytes(0) == 0
        if size <= 0:
            return 0
        return max(1, min(int(size), math.ceil(self.ratio * size)))

    def _keep(self, flat: torch.Tensor, k: int,
              generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def roundtrip(self, tree, generator, residual=None):
        if residual is not None:
            tree = tree_map(torch.add, tree, residual)
        flat, unravel = ravel(tree)
        k = self._k(flat.numel())
        if k == 0:
            # zero-element no-op: nothing crosses the wire, nothing is
            # dropped, so the residual is (empty) zeros
            return tree, tree_map(torch.zeros_like, tree)
        sent = unravel(self._keep(flat, k, generator))
        return sent, tree_map(torch.sub, tree, sent)


class TopKCodec(_SparsifyingCodec):
    """Keep the largest-magnitude ``ceil(ratio * n)`` coordinates of the
    payload (ties on the threshold bucket broken by index).  Wire format:
    4-byte value + 4-byte index per kept element."""

    def wire_bytes(self, n_floats: float) -> float:
        return math.ceil(self.ratio * float(n_floats)) * 8.0

    def _keep(self, flat, k, generator):
        # the bucketed threshold select: no sort, exactly k survive; the
        # CUDA kernel on CUDA tensors (kernels.ops.topk_select)
        return kernel_ops.topk_select(flat, k, mode=self.kernels)


class RandKCodec(_SparsifyingCodec):
    """Keep ``ceil(ratio * n)`` uniformly random coordinates.  The index
    set comes from a seed the server shares, so only the 4-byte values
    cross the wire.  Plain PyTorch: the reference has no kernel here."""

    def wire_bytes(self, n_floats: float) -> float:
        return math.ceil(self.ratio * float(n_floats)) * 4.0

    def indices(self, n: int, k: int,
                generator: torch.Generator) -> torch.Tensor:
        """The k kept coordinates of an n-element payload, drawn without
        replacement from ``generator`` (on its device)."""
        return torch.randperm(n, generator=generator,
                              device=generator.device)[:k]

    def _keep(self, flat, k, generator):
        idx = self.indices(flat.numel(), k, generator).to(flat.device)
        out = torch.zeros_like(flat)
        out[idx] = flat[idx]
        return out


# ---------------------------------------------------------------------------
# Registry (mirrors repro_torch.fed.strategies)
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, Callable[..., PayloadCodec]] = {}


def register(name: str, factory: Optional[Callable[..., PayloadCodec]] = None):
    """Register ``factory([param]) -> PayloadCodec`` under ``name``.
    Usable as a decorator on a codec class or called directly."""

    def _do(f):
        try:
            f.name = name
        except (AttributeError, TypeError):
            pass
        _REGISTRY[name] = f
        return f

    return _do if factory is None else _do(factory)


def get(name: str) -> Callable[..., PayloadCodec]:
    if name not in _REGISTRY:
        raise ValueError(f"unknown payload codec {name!r}; known: {names()}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def make(spec: str | PayloadCodec,
         kernels: Optional[str] = None) -> PayloadCodec:
    """Build a codec from a ``FedConfig.compress`` spec: a PayloadCodec
    instance (returned as-is) or a ``"name"`` / ``"name:param"`` string.
    ``kernels`` ("auto" | "on" | "off") sets the encode kernel knob; None
    keeps the class default ("auto")."""
    if isinstance(spec, PayloadCodec):
        codec = spec
    else:
        if not isinstance(spec, str):
            raise ValueError(
                f"codec spec must be a string or PayloadCodec, got {spec!r}")
        name, _, arg = spec.partition(":")
        factory = get(name)
        try:
            codec = factory(float(arg)) if arg else factory()
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad codec spec {spec!r}: {e}") from None
    if kernels is not None:
        if kernels not in kernel_ops.MODES:
            raise ValueError(
                f"codec kernels mode must be one of {kernel_ops.MODES}, "
                f"got {kernels!r}")
        codec.kernels = kernels
    return codec


def achieved_ratio(codec: PayloadCodec, n_floats: float) -> float:
    """``wire_bytes / raw float32 bytes`` (1.0 = uncompressed; an empty
    payload is 1.0 by convention)."""
    raw = float(n_floats) * comm.BYTES_F32
    if raw <= 0:
        return 1.0
    return float(codec.wire_bytes(n_floats)) / raw


register("none", NoneCodec)
register("int8", Int8Codec)
register("topk", TopKCodec)
register("randk", RandKCodec)

# the shared passthrough instance: the default wire format of a PhasePlan
NONE = NoneCodec()
