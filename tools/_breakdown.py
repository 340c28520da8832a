"""What the breakdown scripts of ``tools/`` share: the card's name line,
device and call times of one call, and builds of text-substituted variants
of a kernel source (``--cuts``)."""
from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

SLEEP_CYCLES = 20_000_000   # ~10 ms at the H100's ~2 GHz SM clock


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def time_ms(fn, reps: int = 21, per: int = 10) -> tuple[float, float]:
    """-> (device ms, call ms) of one call of ``fn``, medians over reps:
    ``per`` calls queued behind a ``torch.cuda._sleep`` (host cost hidden),
    and one call from an idle device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    device, call = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / per)
        start.record()
        fn()
        end.record()
        end.synchronize()
        call.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(call)


def build_cuts(_build, tool: str, source: str, cuts: dict, entry: str,
               argtypes: list) -> dict:
    """name -> the ``entry`` function of each variant of ``csrc/<source>.cu``
    (``cuts``: name -> [(text, its replacement), ...], each text found once)
    and of the source as it is ("whole"), all compiled at once into
    ``<build dir>/<tool>``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = _build.BUILD_DIR / tool
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, subs in {"whole": [], **cuts}.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{tool}: {name}: {old!r} is not once in the "
                                 "source")
            text = text.replace(old, new)
        cu, so = out / f"{name}.cu", out / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_build.nvcc(), *_build._flags(source), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{tool}: building {name} failed:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries
