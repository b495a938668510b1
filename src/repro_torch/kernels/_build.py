"""Build and bind the CUDA kernels: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/<name>-<digest>.so`` at
the repository root, where ``<digest>`` hashes the source, the shared
headers and the compiler flags — an edited source rebuilds, an unchanged
one loads.  :func:`build_all` starts one ``nvcc`` per missing library, all
together, and waits for every one; the first :func:`load` calls it.  The
compiler's register/shared-memory report (``-Xptxas -v``) is kept beside
each library as ``<name>-<digest>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("paged_kvattn", "kvattn", "mpgemm", "mpgemm_int8",
           "flash_prefill", "flash_prefill_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, Callable] = {}


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    """Where library ``name`` of the current sources is built."""
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built from csrc/ at first use")
    return found


def build_all(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every library in ``names`` that is not built yet — one
    ``nvcc`` per source, started together — and return their paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
        else:
            os.replace(tmp, out)      # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return [lib_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (building all missing ones first)."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def bind(name: str, fn: str, n_ptr: int, n_int: int):
    """C entry point ``fn`` of library ``name`` taking ``n_ptr`` pointers,
    ``n_int`` ints and the stream (a pointer), returning a CUDA error.
    Bound once per process."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FNS[(name, fn)] = f
    return f


def check_operands(dev: torch.device, checks: Sequence[Tuple]) -> None:
    """Raise ``ValueError`` unless every ``(name, tensor, dtype, shape)``
    is a contiguous tensor of that dtype and shape on ``dev`` — what a
    kernel reading raw pointers takes."""
    for name, t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} "
                             f"{tuple(shape)} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
