"""ctypes binding of the repository's native host-side preprocessing
library, ``native/preprocess.cpp``, built by the port itself.

Counterpart of ``blurr_tpu/native.py``, which builds with ``make -C
native`` and so writes ``native/libblurr_native.so``. The port reads
``native/preprocess.cpp`` as data and never writes under ``native/``: at
first use it runs

    g++ -O3 -march=native -fPIC -fopenmp -shared -o <lib> native/preprocess.cpp

into ``blurr_tpu_torch/_build/native/<hash>/libblurr_native.so`` (listed in
``.gitignore``), keyed by a hash of the source, the flags and what
``-march=native`` selects on this machine, under a lock
(a thread lock in the process; the library is written to a temporary name
and renamed, so a concurrent process never loads half a file). It binds both
entry points and checks ``blurr_native_version() == 1``. If the build or
the load fails, ``available()`` is False, the reason is logged once at
WARNING, and the resize ladder (``utils/image.py``) moves to its next rung,
as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parents[1] / "native" / "preprocess.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-shared")
_U8P = ctypes.POINTER(ctypes.c_uint8)


class _State:
    """The process's one build-and-load attempt."""

    lock = threading.Lock()
    lib: Optional[ctypes.CDLL] = None
    failed = False


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


@functools.cache
def _native_target(cxx: str) -> bytes:
    """What ``-march=native`` means to ``cxx`` on this machine, so that a
    library built for another CPU is never loaded here."""
    return subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, timeout=60).stdout


def library_path(build_root: Optional[Path] = None) -> Path:
    """Where the library is built (under ``BUILD_ROOT`` by default): a hash
    of the source, the flags and what ``-march=native`` selects here."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_native_target(_cxx()))
    return (build_root or BUILD_ROOT) / h.hexdigest()[:16] / "libblurr_native.so"


def build(build_root: Optional[Path] = None) -> Path:
    """Compile ``native/preprocess.cpp`` unless the hashed library exists;
    raises ``RuntimeError`` with the compiler's output when g++ fails."""
    out = library_path(build_root)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} did not run: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.lanczos4_resize_u8.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _U8P, ctypes.c_int, ctypes.c_int,
    ]
    lib.lanczos4_resize_u8.restype = None
    lib.lanczos4_resize_normalize_chw.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
    ]
    lib.lanczos4_resize_normalize_chw.restype = None
    lib.blurr_native_version.argtypes = []
    lib.blurr_native_version.restype = ctypes.c_int
    version = lib.blurr_native_version()
    if version != 1:
        raise RuntimeError(f"blurr_native_version() is {version}, not 1")
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at the first call; None when it
    cannot be built or loaded (the reason logged once)."""
    if _State.lib is not None or _State.failed:
        return _State.lib
    with _State.lock:
        if _State.lib is None and not _State.failed:
            try:
                _State.lib = _bind(build())
            except (OSError, RuntimeError) as exc:
                _State.failed = True
                log.warning("native preprocessing library unavailable, the resize "
                            "ladder skips its rung: %s", exc)
    return _State.lib


def available() -> bool:
    return get_lib() is not None


def _checked(image: np.ndarray, channels=None) -> np.ndarray:
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3:
        raise ValueError(f"expected a uint8 HxWxC image, got {image.dtype} {image.shape}")
    if channels is not None and image.shape[2] != channels:
        raise ValueError(f"expected {channels} channels, got {image.shape[2]}")
    return image


def lanczos4_resize(image: np.ndarray, out_hw) -> Optional[np.ndarray]:
    """uint8 [H, W, C] -> uint8 [out_h, out_w, C]; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    image = _checked(image)
    h, w, c = image.shape
    out_h, out_w = (int(v) for v in out_hw)
    out = np.empty((out_h, out_w, c), np.uint8)
    lib.lanczos4_resize_u8(image.ctypes.data_as(_U8P), h, w, c,
                           out.ctypes.data_as(_U8P), out_h, out_w)
    return out


def lanczos4_resize_normalize_chw(
    image: np.ndarray, out_hw, mean: float = 0.5, std: float = 0.5
) -> Optional[np.ndarray]:
    """uint8 [H, W, 3] -> float32 [3, out_h, out_w] ((x/255 - mean) / std);
    None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    image = _checked(image, channels=3)
    h, w, _ = image.shape
    out_h, out_w = (int(v) for v in out_hw)
    out = np.empty((3, out_h, out_w), np.float32)
    lib.lanczos4_resize_normalize_chw(
        image.ctypes.data_as(_U8P), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        ctypes.c_float(mean), ctypes.c_float(std),
    )
    return out
