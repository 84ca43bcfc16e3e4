"""Build the port's CUDA C++ sources with ``nvcc`` and load them with ctypes.

Each source under ``znicz_tpu_torch/csrc/`` has a plain C interface and no
PyTorch headers, so one ``nvcc`` call takes seconds.  It is compiled for
``sm_90a`` at first use into ``build/kernels/`` at the repository root,
under a name keyed by the hash of the source and the flags, so a changed
source builds anew and an unchanged one is loaded as it is.  Without
``nvcc`` (on ``PATH``, or under ``$CUDA_HOME/bin``) the build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    path: Path  # the shared library
    seconds: float  # nvcc's wall time; 0.0 when the library was there already
    log: str  # nvcc's output: ptxas' registers, shared memory and spills


def nvcc_path() -> str:
    """The ``nvcc`` to build with; raises ``RuntimeError`` when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from source at first use and have no fallback"
    )


def build(name: str, *, build_dir: Optional[Path] = None) -> Built:
    """Compile ``csrc/<name>.cu`` into ``<build_dir>/<name>-<hash>.so`` unless
    that file exists; returns where it is, the build's seconds and log."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    out_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    lib = out_dir / f"{name}-{digest}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return Built(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=900,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a reader never sees a partial library
    return Built(lib, seconds, log)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it first if needed),
    loaded once per process."""
    return ctypes.CDLL(str(build(name).path))
