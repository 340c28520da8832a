"""No host sync in the fleet backend's device bodies, on the CPU.

The bodies of ``repro_torch.edge.fleet.kernel`` (``_bw_widths``,
``_energy_widths``, ``_sync_round`` with and without re-allocation) run at
a few thousand clients under a ``TorchDispatchMode`` that records every
aten op which, on a CUDA tensor, waits for the device: a host read of a
value (``_local_scalar_dense``, what ``.item()``, ``bool(t)`` and
indexing by a 0-d tensor dispatch), an op whose output shape depends on
the data (``nonzero``, ``masked_select``, ``unique``,
``repeat_interleave``), or a tensor made from host data
(``lift_fresh``: a blocking host->device copy).  None may appear.
``chip_smoke.py``'s ``sync`` phase checks the same bodies, and the kernel
wrappers, on the card under ``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.edge.allocation import BISECT_ITERS  # noqa: E402
from repro_torch.edge.fleet import kernel  # noqa: E402

SYNCING = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
           "unique_dim", "unique_consecutive", "repeat_interleave",
           "lift_fresh"}
N = 4000


class SyncRecorder(TorchDispatchMode):
    """Records the syncing aten ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in SYNCING:
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


def _f64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.fixture(scope="module")
def fleet():
    """A cohort of N clients: upload bytes, SNR, compute times, energy
    weights, and equal widths (bandwidth_opt's would equalise every
    finish) under per-client deadlines that drop some of them early, so
    that re-allocation moves survivors' finishes."""
    rng = np.random.default_rng(0)
    snr = _f64(10.0 ** rng.normal(1.0, 0.4, N))
    up_bytes = _f64(np.full(N, 8.0 * 206_922))
    tc = _f64(rng.lognormal(np.log(5.0), 1.0, N))
    budget = 2e5 * N
    w = _f64(np.full(N, 2e5))
    finish = tc + 8.0 * up_bytes / (w * torch.log2(1.0 + snr))
    return dict(snr=snr, up_bytes=up_bytes, tc=tc, budget=budget, w=w,
                deadline=finish * _f64(rng.uniform(0.7, 1.3, N)),
                c=_f64(rng.uniform(0.1, 2.0, N)),
                w_min=_f64(rng.uniform(1e3, 1e5, N)),
                feas=torch.as_tensor(rng.uniform(size=N) < 0.9),
                e_comp=_f64(rng.uniform(1.0, 5.0, N)),
                battery=_f64(np.full(N, 50.0)), srv_rate=_f64(1e9))


def _bodies(f):
    return {
        "bw_widths": lambda: kernel._bw_widths(
            8.0 * f["up_bytes"], torch.log2(1.0 + f["snr"]), f["tc"],
            f["budget"], BISECT_ITERS),
        "energy_widths": lambda: kernel._energy_widths(
            f["c"], f["w_min"], f["feas"], f["budget"], BISECT_ITERS),
        **{f"sync_round_realloc_{r}": (lambda r=r: kernel._sync_round(
            f["w"], f["snr"], f["tc"], f["up_bytes"], f["e_comp"],
            f["deadline"], 1e-9, 0.2, f["srv_rate"], 0.01, f["battery"],
            f["up_bytes"], r)) for r in (False, True)},
    }


BODIES = ["bw_widths", "energy_widths", "sync_round_realloc_False",
          "sync_round_realloc_True"]


@pytest.mark.parametrize("body", BODIES)
def test_fleet_body_dispatches_no_syncing_op(fleet, body):
    run = _bodies(fleet)[body]
    with SyncRecorder() as rec:
        out = run()
    assert rec.hits == []
    assert all(torch.isfinite(t).all() for t in
               (out if isinstance(out, tuple) else (out,)))


def test_sync_round_drops_and_reallocates(fleet):
    """The sync-round inputs exercise the re-allocation branch."""
    out = kernel._sync_round(
        fleet["w"], fleet["snr"], fleet["tc"], fleet["up_bytes"],
        fleet["e_comp"], fleet["deadline"], 1e-9, 0.2, fleet["srv_rate"],
        0.01, fleet["battery"], fleet["up_bytes"], True)
    n_dropped, n_realloc = int(out[3]), int(out[6])
    assert 0 < n_dropped < N and n_realloc > 0


def test_recorder_sees_the_parent_host_read(fleet):
    """The recorder is not blind: the parent's selection, indexing by a
    0-d argmax, and a tensor made from host data inside a body, both show."""
    cands = fleet["tc"][:8]
    fits = cands <= 5.0
    with SyncRecorder() as rec:
        cands[torch.argmax(fits.to(torch.int8))]
        torch.as_tensor(np.asarray(1.0))
    assert rec.hits == ["_local_scalar_dense", "lift_fresh"]
