"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, at first use, into
``build/overiva_tpu_torch/`` at the repository root. The library's file
name carries a hash of the sources and flags, so an edited source is never
served by a stale build. It is loaded with ctypes; each entry point's
``argtypes`` are declared here.

There is no fallback: a host without ``nvcc`` gets a RuntimeError that
says so, and a failed compile raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "build_library", "library", "ptxas_summary"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "overiva_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# where the CUDA toolkit is looked for after $CUDA_HOME and $PATH
CUDA_ROOTS = ("/usr/local/cuda",)


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then $PATH, then CUDA_ROOTS."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates += [Path(root) / "bin" / "nvcc" for root in CUDA_ROOTS]
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, $PATH, "
        f"{', '.join(CUDA_ROOTS)}): the CUDA kernels of overiva_tpu_torch "
        "are built from source at first use and need the CUDA toolkit; "
        "CPU tensors take the plain PyTorch path and need no build"
    )


def build_library() -> Path:
    """Compile ``csrc/*.cu`` if this exact build is not there yet.

    Returns the library's path. Each source compiles in its own ``nvcc``
    process, all at once; one more ``nvcc`` links the objects. The
    compilers' output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<library>.log``.
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libovt_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}) compiling {src.name}:\n{log}"
                )
        so = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so), *map(str, objects)],
            capture_output=True, text=True, check=False,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {link.returncode}) linking "
                f"{[o.name for o in objects]}:\n{link.stdout}{link.stderr}"
            )
        Path(f"{lib}.log").write_text("".join(logs))
        os.replace(so, lib)  # atomic: a reader never sees a partial file
    return lib


def ptxas_summary(log: str) -> list[str]:
    """One line per kernel of a build log made with ``-Xptxas -v``: its
    name (with its template arguments), registers, stack frame and spills."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            found = re.search(r"[A-Za-z_]+kernel", mangled)
            name = found.group(0) if found else mangled
            args = re.match(r"I((?:Li\d+E)+)E", mangled[found.end():]) if found else None
            if args:
                name += "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
            frame = ""
            continue
        props = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line
        )
        if props and name:
            frame = "{} B stack, {} B spill stores, {} B spill loads".format(*props.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            rows.append(f"{name}: {used.group(1)} registers, {frame}")
            name = None
    return rows


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build_library()))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wcov_packed_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.wcov_packed_launch.restype = ci
    lib.wcov_packed_error_string.argtypes = [ci]
    lib.wcov_packed_error_string.restype = ctypes.c_char_p
    lib.update_rows_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.update_rows_launch.restype = ci
    lib.update_rows_error_string.argtypes = [ci]
    lib.update_rows_error_string.restype = ctypes.c_char_p
    ll = ctypes.c_longlong
    lib.tap_steps_launch.argtypes = [vp, vp, vp, vp, vp, ll, ll, vp, ci, ci, ci, ci, ci, vp]
    lib.tap_steps_launch.restype = ci
    lib.tap_steps_error_string.argtypes = [ci]
    lib.tap_steps_error_string.restype = ctypes.c_char_p
    lib.iss_steps_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.iss_steps_launch.restype = ci
    lib.iss_steps_error_string.argtypes = [ci]
    lib.iss_steps_error_string.restype = ctypes.c_char_p
    return lib
