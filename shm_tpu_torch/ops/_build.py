"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/<name>-<hash>.so`` at the repository root (git-ignored),
keyed by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads the existing library. The target is Hopper
(``sm_90a``); there is no ``--use_fast_math`` (it changes ``expf``/``tanhf``).
A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needs the CUDA toolkit on PATH or "
                       "under /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Compile every named source that has no library yet, all nvcc processes
    started together. Returns ``{name: (path, seconds, ptxas log)}``; the log
    is empty and seconds 0 for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = (path, 0.0, "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       path, tmp, time.perf_counter())
    errors = []
    for name, (proc, path, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):"
                          f"\n{stderr}{stdout}")
            continue
        os.replace(tmp, path)                    # atomic: no half-written .so
        out[name] = (path, seconds, stderr + stdout)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed, once
    per process: threads that ask at the same time wait for the one build
    and load. Every source exports ``shm_cuda_error_string``; it is declared
    here."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path, _, _ = build([name])[name]
            lib = ctypes.CDLL(str(path))
            lib.shm_cuda_error_string.restype = ctypes.c_char_p
            lib.shm_cuda_error_string.argtypes = [ctypes.c_int]
            _LOADED[name] = lib
        return lib


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to the launch counter ``fn.<attr>``; safe when several host
    threads launch kernels at once."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for the non-zero CUDA error code a C entry of ``lib`` returned."""
    if err != 0:
        msg = lib.shm_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


__all__ = ["build", "count_launch", "load_library", "raise_on_error",
           "library_path", "BUILD_DIR", "CSRC"]
