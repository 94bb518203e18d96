"""Build the CUDA C++ kernels in ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` is compiled on its own, at first use, into a
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``; ``c_function`` looks a C function up in it
once, with its argument types. The file name carries a hash of the source,
the headers beside it (``csrc/*.cuh``) and the flags, so an edited source
is rebuilt and an unchanged one is reused.
Nothing here includes PyTorch's headers (a build takes seconds, not
minutes). There is no fallback: without ``nvcc`` or with a failing build
the call raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library and how it was obtained."""

    name: str
    lib: ctypes.CDLL
    path: Path
    log: str                 # nvcc's output (``-Xptxas -v``); "" if reused
    build_seconds: float     # 0.0 when an up-to-date build was reused


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "ganlab_tpu_torch are built from source at first use")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when an up-to-date build exists."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> KernelLibrary:
    _, out = _target(name)
    log, seconds = "", 0.0
    if started is not None:
        proc, tmp, out, t0 = started
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return KernelLibrary(name, ctypes.CDLL(str(out)), out, log, seconds)


@functools.cache
def library(name: str) -> KernelLibrary:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return _finish(name, _start(name))


@functools.cache
def c_function(name: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of ``csrc/<name>.cu``'s library, given its
    argument types and its ``int`` result (a CUDA error or a plan code)
    once; later calls are one cache lookup."""
    fn = getattr(library(name).lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_all() -> list[KernelLibrary]:
    """Build every ``csrc/*.cu`` at once (one nvcc each, run in parallel)."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return [_finish(n, started[n]) for n in names]
