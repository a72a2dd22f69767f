"""ctypes loader/builder for the native C++ RIR engine: the port's copy of
``overiva_tpu/sim/_native.py``, building the port's own copy of the source,
``overiva_tpu_torch/csrc/rir.cpp`` (byte-identical to ``native/rir.cpp``).

Builds the shared library on first use with g++ into
``build/overiva_tpu_torch/librir.so`` at the repository root, beside the
port's CUDA kernels (never into the JAX package's ``build/librir.so``).
A sha256 sidecar of the source, the flags and the host's name and machine
type is checked before every load: the library is built with
``-march=native``, so a stale build, or one made on another host and
copied along with the tree, is rebuilt rather than loaded. Without a
toolchain the NumPy path of ``room.shoebox_rir`` runs instead (host
simulation of the input, not the device path). Disable with
OVERIVA_TPU_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "native_shoebox_rir"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "rir.cpp"
_BUILD = _PKG.parent / "build" / "overiva_tpu_torch"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_key() -> str:
    """What a usable build must match: the source, the flags and the host."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS + (platform.node(), platform.machine())).encode())
    return h.hexdigest()


def _build_and_load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("OVERIVA_TPU_NATIVE", "1") == "0" or not _SRC.exists():
        return None
    so = _BUILD / "librir.so"
    sidecar = _BUILD / "librir.so.sha256"
    try:
        key = _build_key()
        stale = (
            not so.exists()
            or not sidecar.exists()
            or sidecar.read_text().strip() != key
        )
        if stale:
            _BUILD.mkdir(parents=True, exist_ok=True)
            # build under a private name, then rename: a concurrent loader
            # never sees a half-written library
            tmp = _BUILD / f"librir.so.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
            sidecar.write_text(key)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None

    d3 = ctypes.POINTER(ctypes.c_double)
    lib.shoebox_rir_capacity.restype = ctypes.c_int64
    lib.shoebox_rir_capacity.argtypes = [
        d3, d3, d3, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.shoebox_rir.restype = ctypes.c_int64
    lib.shoebox_rir.argtypes = [
        d3, d3, d3, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _build_and_load() is not None


def _cvec(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def native_shoebox_rir(
    room_dim, src, mic, fs, absorption, max_order, c, frac_len=81, extra=64
) -> np.ndarray | None:
    """Native RIR, or None when the library is unavailable/errors."""
    lib = _build_and_load()
    if lib is None:
        return None
    room = _cvec(room_dim)
    s = _cvec(src)
    m = _cvec(mic)
    p = lambda arr: arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    cap = lib.shoebox_rir_capacity(
        p(room), p(s), p(m), fs, int(max_order), c, int(frac_len), int(extra)
    )
    if cap <= 0:
        return None
    out = np.zeros(int(cap), dtype=np.float64)
    used = lib.shoebox_rir(
        p(room), p(s), p(m), float(fs), float(absorption), int(max_order),
        float(c), int(frac_len), int(extra), p(out), out.shape[0],
    )
    if used == -1:
        raise ValueError("source and mic must be strictly inside the room")
    if used < 0:
        return None
    return out[: int(used)]
