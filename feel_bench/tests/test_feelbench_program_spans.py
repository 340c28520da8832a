"""The program's spans in the traced run (``harness/program_spans.py``): the
attribution of a device trace to the spans on a hand-built event list, the
six readers' arithmetic, the phase on a program whose train step takes no
tracer, and the rehearsal's traced run, which lists the twelve readers and
reads each as nothing on the CPU.  No number from here is a device number."""
from __future__ import annotations

import io
import time
from types import SimpleNamespace

import pytest
import torch

from harness import manifest, program_spans, runner
from harness.trace import WINDOW

CELLS = {"granite_train.s4096": "train", "granite_train.s512": "train_short"}
NAMES = ["combine_ms", "two_loop_ms", "server_passes_ms", "backward_ms",
         "cohort_idle_ms", "launches_per_step"]


class Ev:
    """One event of a profile, with the kineto event's methods."""

    def __init__(self, name, a_us, b_us, cuda=False, corr=0, linked=0,
                 note=False):
        self._v = (name, a_us, b_us, cuda, corr, linked, note)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1e3)

    def duration_ns(self):
        return int((self._v[2] - self._v[1]) * 1e3)

    def device_type(self):
        cuda = torch.autograd.DeviceType
        return cuda.CUDA if self._v[3] else cuda.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _events():
    """A window (0-100 us) around train.step (0-90) holding train.cohort
    (5-50) > train.backward (10-40), and server (60-85) > server.combine
    (65-80).  Launch calls (host, us): 12 and 20 in the backward (the
    second one's device op lost by the trace), 42 in the cohort, a copy at
    67 in the combine, one at -20 before the window; a call that launches
    nothing at 13.  Device ops (us): k1 (12's) runs 15-30; k2 has no call
    but its linked operator at 66 (combine) and runs 45-55; k3 (42's) runs
    56-58; k4 has no launch found and starts at 70; k5 (-20's) runs -10-3;
    the copy runs 81-82; a mirror of the combine's range is left out."""
    return [
        Ev(WINDOW, 0, 100, corr=1, note=True),
        Ev("train.step", 0, 90, corr=2, note=True),
        Ev("train.cohort", 5, 50, corr=3, note=True),
        Ev("train.backward", 10, 40, corr=4, note=True),
        Ev("server", 60, 85, corr=5, note=True),
        Ev("server.combine", 65, 80, corr=6, note=True),
        Ev("cudaLaunchKernel", 12, 13, corr=900, linked=7),
        Ev("cudaStreamIsCapturing", 13, 14, corr=905, linked=7),
        Ev("cudaLaunchKernel", 20, 21, corr=903, linked=7),
        Ev("aten::mm", 11, 22, corr=7),
        Ev("aten::addcmul_", 66, 67, corr=8),
        Ev("cudaLaunchKernel", 42, 43, corr=901, linked=9),
        Ev("aten::add_", 41, 44, corr=9),
        Ev("cudaMemcpyAsync", 67, 68, corr=904, linked=10),
        Ev("aten::copy_", 66.5, 69, corr=10),
        Ev("cudaLaunchKernel", -20, -19, corr=902),
        Ev("k1", 15, 30, cuda=True, corr=900, linked=7),
        Ev("k2", 45, 55, cuda=True, corr=555, linked=8),
        Ev("k3", 56, 58, cuda=True, corr=901, linked=9),
        Ev("k4", 70, 72, cuda=True, corr=777, linked=0),
        Ev("k5", -10, 3, cuda=True, corr=902),
        Ev("Memcpy DtoH", 81, 82, cuda=True, corr=904, linked=10),
        Ev("server.combine", 45, 55, cuda=True, note=True),
    ]


def test_attribution_on_a_hand_built_trace():
    names = {"train.step", "train.cohort", "train.backward", "server",
             "server.combine"}
    ranges, window, ops, launches = program_spans.device_ops(_events(), names)
    assert window == pytest.approx((0.0, 100e-6))
    assert sorted(n for n, _, _ in ranges) == sorted(names)
    assert sorted(launches) == pytest.approx([-20e-6, 12e-6, 20e-6, 42e-6, 67e-6])
    launch = {n: t for n, _, _, t in ops}
    assert set(launch) == {"k1", "k2", "k3", "k4", "k5", "Memcpy DtoH"}
    assert launch["k1"] == pytest.approx(12e-6)        # its runtime call
    assert launch["k2"] == pytest.approx(66e-6)        # its linked operator
    assert launch["k4"] is None
    att = program_spans.attribute(ranges, ops, window, launches)
    assert att["launches"] == {"train.backward": 2, "train.cohort": 1,
                               "server.combine": 1}
    assert att["total"] == 4
    assert att["device_ops"] == 5 and att["unlinked"] == 1
    want_k = {"train.backward": 15e-6, "server.combine": 11e-6,
              "train.cohort": 2e-6, "outside": 2e-6}
    assert att["kernel_s"].keys() == want_k.keys()
    for k, v in want_k.items():
        assert att["kernel_s"][k] == pytest.approx(v), k
    # busy 15-30, 45-55, 56-58, 70-72, 81-82; idle 0-15 (mid 7.5: cohort),
    # 30-45 (mid 37.5: backward), 55-56 (mid 55.5: step), 58-70 (mid 64:
    # server), 72-81 (mid 76.5: combine), 82-100 (mid 91: outside)
    assert att["busy_s"] == pytest.approx(30e-6)
    want = {"train.cohort": 15e-6, "train.backward": 15e-6, "train.step": 1e-6,
            "server": 12e-6, "server.combine": 9e-6, "outside": 18e-6}
    assert att["idle_s"].keys() == want.keys()
    for k, v in want.items():
        assert att["idle_s"][k] == pytest.approx(v), k
    assert att["busy_s"] + sum(att["idle_s"].values()) == pytest.approx(100e-6)
    assert att["stray"] == []


def test_readers_arithmetic():
    dev = {"server.combine": 80.0, "server.two_loop": 3.0, "server.fim_ema": 1.0,
           "server.step": 2.0, "server.smooth_y": 4.0, "server.curvature": 8.0,
           "server.push": 16.0, "server.gram": 50.0, "train.backward": 300.0}
    idle = {"train.cohort": 0.001, "train.forward": 0.002, "train.backward": 0.004,
            "train.accumulate": 0.008, "server": 1.0, "outside": 2.0}
    ctx = SimpleNamespace(program_spans={
        "device_ms": dev, "profile_units": 2,
        "profile": {"idle_s": idle, "total": 7000}})
    assert program_spans.combine_ms(ctx) == 80.0
    assert program_spans.two_loop_ms(ctx) == 3.0
    assert program_spans.server_passes_ms(ctx) == 31.0
    assert program_spans.backward_ms(ctx) == 300.0
    assert program_spans.cohort_idle_ms(ctx) == pytest.approx(7.5)
    assert program_spans.launches_per_step(ctx) == 3500.0
    # no card: no event pairs, no device ops
    ctx = SimpleNamespace(program_spans={"device_ms": None, "profile_units": 2,
                                         "profile": {"idle_s": idle, "total": 0}})
    assert all(getattr(program_spans, n)(ctx) is None for n in NAMES)


class _Entry:
    traffic = {"profile_units": 1}

    def __init__(self):
        self.step_fn = object()

    def sync(self):
        raise AssertionError("the phase ran")


def test_a_program_without_spans_gives_nothing_to_read(monkeypatch):
    """A train step that takes no tracer (the program before its spans):
    the phase returns None at once, and each reader too."""
    from repro_torch.launch import train

    def make_train_step(cfg, ocfg, n_micro=4, optimizer="fim_lbfgs",
                        kernels="auto", mesh=None):
        raise AssertionError("built")

    monkeypatch.setattr(train, "make_train_step", make_train_step)
    entry = _Entry()
    entry.arch = entry.cfg = None
    assert program_spans.traced_step(entry, None) is None
    ctx = SimpleNamespace(spans=SimpleNamespace(sync=entry.sync, units=[]))
    assert all(getattr(program_spans, n)(ctx) is None for n in NAMES)
    assert ctx.program_spans is None
    assert program_spans.phase(SimpleNamespace(spans=None)) is None


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_rehearsal_lists_the_span_readers(smoke_root, cell, capsys):
    suffix = CELLS[cell]
    mf = manifest.Cell(manifest.load(smoke_root), cell, smoke_root)
    listed = {m["name"] for m in mf.per_layer}
    assert {f"{n}.{suffix}" for n in NAMES} <= listed
    out, err = io.StringIO(), io.StringIO()
    result = runner.run_cell(cell, 2**31 + 23, 0.5, True, torch.device("cpu"),
                             time.perf_counter(), root=smoke_root, out=out, err=err)
    assert result["correct"], err.getvalue()
    for n in NAMES:
        assert f"{n}.{suffix}" not in result["metrics"]
        assert f"metric {n}.{suffix}: nothing to read" in err.getvalue()
    table = capsys.readouterr().err
    assert "program spans: ms a step on the host clock" in table
    for span in ("train.cohort", "train.backward", "server.combine", "server.push"):
        assert f"\n{span} " in table
