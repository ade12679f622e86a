"""Builds and loads the port's CUDA kernels.

The JAX package has no counterpart: Pallas kernels compile inside
``jax.jit``. Here each kernel is CUDA C++ for Hopper under ``csrc/``, built
at first use with ``nvcc`` into a shared library with a plain C interface
and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/lib<name>.so csrc/<name>.cu

The library goes to ``blurr_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and the flags, so a rerun
with the same sources does not rebuild. Only the sources in the package
are compiled. Without ``nvcc`` the build raises; nothing falls back.
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

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source and have no fallback"
    )


def _sources(name: str):
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} is missing")
    return [src, *sorted(CSRC_DIR.glob("*.cuh"))]


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built."""
    h = hashlib.sha256()
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists. The
    compiler's output (registers, shared memory, spills from ``-Xptxas -v``)
    is kept beside the library as ``build.log``."""
    out = library_path(name)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load the library of kernel ``name`` (once per
    process)."""
    return ctypes.CDLL(str(build(name)))


def build_log(name: str) -> str:
    """The compiler output of the last build of ``name`` ('' if none)."""
    log = library_path(name).parent / "build.log"
    return log.read_text() if log.is_file() else ""
