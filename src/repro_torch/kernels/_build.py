"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the repository root, then loaded with
``ctypes``.  Libraries are named by a hash of their source and flags, so
an edited source is rebuilt.  Building happens at first use (or up front
through :func:`build_all`, which starts one ``nvcc`` per source at once);
it never happens when a module is imported.  A missing ``nvcc`` or a
failed compile raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# per-source extra flags: the int8 round-trip must not contract a*b+c into
# an FMA, or it stops being bit-identical to the plain version; the flash
# source's twenty kernels compile in parallel (10.5 s against 23.7 s on the
# H100 host's 8 cores)
EXTRA_FLAGS = {"codec_ops": ("-fmad=false",),
               "flash_attention": ("-split-compile=0",)}
SOURCES = ("fim_diag", "vlbfgs", "codec_ops", "topk", "flash_attention")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels of repro_torch cannot be built")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> list[Path]:
    """Compile every library of ``names`` not built yet, one ``nvcc`` per
    source, all started together; waits for all and raises on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = None
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        exe = exe or nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("building repro_torch kernels failed:\n"
                           + "\n".join(failures))
    return [library_path(n) for n in names]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built if needed), with ``argtypes``
    set from ``signatures`` and every entry point returning the
    ``cudaGetLastError()`` code as a C int."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            entry = getattr(lib, fn)
            entry.argtypes = list(argtypes)
            entry.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
