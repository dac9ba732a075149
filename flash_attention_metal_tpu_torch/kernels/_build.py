"""Build the CUDA sources under ``csrc/`` into one shared library.

The library has a plain C interface and is loaded with ``ctypes``, so the
build needs ``nvcc`` alone (no PyTorch headers: seconds, not minutes).  It
is built at first use into ``_build/`` inside the package, under a name
keyed by a hash of the sources, their headers (``csrc/*.cuh``) and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are compiled from csrc/ at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for them already exists."""
    out = library_path()
    if out.exists():
        return out
    return compile_library(_sources(), out)


def _run(procs) -> None:
    """Wait for every ``(cmd, Popen)``; raise with the output of a failure."""
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def compile_library(sources, out: Path) -> Path:
    """Compile ``sources`` with ``NVCC_FLAGS`` into the library ``out``.

    Each source compiles to an object in its own ``nvcc`` process, all
    started together; one more links them.  Headers are found beside the
    source first, then in ``csrc/``.
    """
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        objects, procs = [], []
        for i, src in enumerate(sources):
            obj = os.path.join(work, f"{i}_{Path(src).stem}.o")
            cmd = [nvcc, *compile_flags, "-I", str(CSRC), "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            objects.append(obj)
        _run(procs)
        # Link to a private name, then rename: a concurrent process never
        # loads a half-written library.
        tmp = os.path.join(work, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *objects]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built on first call and loaded once."""
    return ctypes.CDLL(str(build()))
