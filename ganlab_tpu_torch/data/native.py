"""ctypes loader and builder of the native data-path library (host code).

Port of ``ganlab_tpu/data/native.py`` over the port's own copy of the C++
source, ``data/_native/gather.cpp``. It is compiled with g++ at first use
into ``ganlab_tpu_torch/_build/gather-<hash>.so`` (the hash covers the
source and the flags; the directory is git-ignored, and ``-march=native``
makes the library one machine's), written under a temporary name and
renamed, so concurrent first uses see a whole library or none. Without a
compiler, or when the build fails, ``gather`` returns None and the callers
take the numpy path, which gives the same bytes: that fallback is logged
once, on stderr, so that a slow host feed is never a silent one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "_native" / "gather.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread",
          "-std=c++17")


class _Native:
    """The library, built and loaded on first use (thread-safe)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.lib: ctypes.CDLL | None = None
        self.tried = False
        self.why_not = ""


_state = _Native()


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"gather-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found on PATH")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}.{threading.get_ident()}")
    try:
        subprocess.run([cxx, *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.ganlab_gather_u8.argtypes = [u8p, i64, i64, i64, i64p, i64, u8p]
    lib.ganlab_gather_u8.restype = None
    lib.ganlab_gather_down_u8.argtypes = [u8p, i64, i64, i64, ctypes.c_int,
                                          i64p, i64, u8p]
    lib.ganlab_gather_down_u8.restype = None
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (the numpy path; logged once)."""
    st = _state
    with st.lock:
        if st.lib is None and not st.tried:
            st.tried = True
            try:
                st.lib = _load(_build())
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", "") or ""
                st.why_not = f"{e} {detail}".strip()
                print("ganlab_tpu_torch.data.native: the native gather "
                      "library is not available; batches are gathered and "
                      f"downsampled in numpy (same bytes): {st.why_not}",
                      file=sys.stderr, flush=True)
        return st.lib


def available() -> bool:
    return get_lib() is not None


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def gather(src: np.ndarray, idx: np.ndarray,
           factor: int = 1) -> np.ndarray | None:
    """Parallel ``out[b]`` = (optionally box-downsampled) ``src[idx[b]]``.

    src: (N, H, W, C) uint8, C-contiguous (may be a memmap); idx: (B,)
    indices in [0, N). Returns None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    if src.dtype != np.uint8 or src.ndim != 4 or \
            not src.flags["C_CONTIGUOUS"]:
        raise ValueError(f"gather: need a C-contiguous uint8 (N, H, W, C) "
                         f"array, got {src.dtype} {src.shape}")
    n, h, w, c = src.shape
    if factor < 1 or h % factor or w % factor:
        raise ValueError(f"gather: factor {factor} does not divide {h}x{w}")
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= n)):
        raise IndexError(f"gather: indices outside [0, {n})")
    b = idx.shape[0]
    idx_p = idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    if factor == 1:
        out = np.empty((b, h, w, c), np.uint8)
        lib.ganlab_gather_u8(_as_u8p(src), h, w, c, idx_p, b, _as_u8p(out))
    else:
        out = np.empty((b, h // factor, w // factor, c), np.uint8)
        lib.ganlab_gather_down_u8(_as_u8p(src), h, w, c, factor, idx_p, b,
                                  _as_u8p(out))
    return out
