"""Build and load the port's CUDA kernels.

Each kernel source `csrc/<name>.cu` exposes a plain C interface. At first
use it is compiled by `nvcc` for Hopper (`sm_90a`) into a shared library
under `_build/`, keyed by a hash of the source and the flags, and loaded
with ctypes. A later call in the same process, or a later process on the
same checkout, reuses the library. Nothing is built when a module is
imported: the CPU tests import every module and have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import typing as tp
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Build(tp.NamedTuple):
    path: Path
    seconds: float   # nvcc's time; 0.0 when the library was already built
    log: str         # what nvcc printed, ptxas' register and spill counts too


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def compile_library(out: Path, command: tp.Callable[[str], list[str]],
                    what: str) -> Build:
    """Run `command(tmp)`, a compiler call that writes a shared library to
    `tmp`, in `out`'s directory, and move the result to `out`; raise with
    the compiler's stderr when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed for {what}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process never loads half a file
    return Build(out, took, proc.stdout + proc.stderr)


def build(name: str) -> Build:
    """Compile `csrc/<name>.cu` unless the library for this source exists."""
    out = library_path(name)
    if out.exists():
        return Build(out, 0.0, "")
    src = str(CSRC / f"{name}.cu")
    return compile_library(
        out, lambda tmp: [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], f"{name}.cu")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, loaded once per process."""
    return ctypes.CDLL(str(build(name).path))
