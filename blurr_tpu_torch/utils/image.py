"""Lanczos image resizing: the host ladder of the control loop and the
weight matrices of ``jax.image.resize``.

Counterpart of ``blurr_tpu/utils/image.py``. ``lanczos_resize_uint8`` is
the JAX package's ladder in the same order, for the env adapters and the
action server alike:

1. cv2 ``INTER_LANCZOS4`` (the reference resizes with it);
2. the port's ctypes binding of ``native/preprocess.cpp``
   (``blurr_tpu_torch/native.py``), when it builds;
3. a torch rung that computes what ``jax.image.resize(x, shape,
   "lanczos5")`` computes on fp32, then rounds half to even (as
   ``jnp.round``), clips to 0..255 and casts to uint8.

The rung taken is logged once per process. ``lanczos_weights`` builds the
dense per-axis weight matrix of ``jax/_src/image/scale.py:compute_weight_mat``
(antialiased: the kernel widens by ``1/scale`` when downsampling; no edge
clamp; each output's weights divided by their sum, or 0 where that sum is
at most 1000 fp32 eps; 0 where the sample lies outside the input), in fp32;
``lanczos_resize`` applies one per resized axis with a matmul, the width
first, as XLA contracts them. ``PiZero.infer_action_from_frame`` runs the
lanczos3 form on the device.
"""

from __future__ import annotations

import logging
import math
import threading

import numpy as np
import torch

try:
    import cv2
except Exception:  # pragma: no cover - no cv2 on the machine
    cv2 = None

log = logging.getLogger(__name__)

_F32_EPS = float(np.finfo(np.float32).eps)
# the rungs this process has taken, each logged once
_rungs_logged: set = set()
_rungs_lock = threading.Lock()


def _log_rung(name: str, detail: str) -> None:
    with _rungs_lock:
        if name in _rungs_logged:
            return
        _rungs_logged.add(name)
    log.info("lanczos_resize_uint8: the %s rung (%s)", name, detail)


def lanczos_weights(in_size: int, out_size: int, radius: int, device=None) -> torch.Tensor:
    """fp32 [in_size, out_size]: output j is ``sum_i x[i] * w[i, j]``, the
    weights of ``jax.image.resize(..., method=f"lanczos{radius}")`` along
    one axis (antialias on, translation 0)."""
    f32 = torch.float32
    scale = out_size / in_size  # a Python float, as JAX takes it
    inv_scale = torch.tensor(1.0 / scale, dtype=f32)
    kernel_scale = torch.maximum(inv_scale, torch.tensor(1.0, dtype=f32))
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    pi = torch.tensor(math.pi, dtype=f32)
    y = radius * torch.sin(pi * x) * torch.sin(pi * x / radius)
    denom = torch.where(x != 0, torch.tensor(math.pi**2, dtype=f32) * (x * x), 1.0)
    w = torch.where(x > 1e-3, y / denom, 1.0)
    w = torch.where(x > radius, 0.0, w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = torch.where(inside[None, :], w, 0.0)
    return w if device is None else w.to(device)


def lanczos_resize(x: torch.Tensor, height: int, width: int, radius: int) -> torch.Tensor:
    """fp32 [..., H, W, C] -> [..., height, width, C], as
    ``jax.image.resize`` with ``method=f"lanczos{radius}"``; an axis whose
    size does not change is left as it is. The products run in fp32 on
    ``x``'s device (TF32 must be off on a card: the caller checks)."""
    h, w = x.shape[-3], x.shape[-2]
    if w != width:
        ww = lanczos_weights(w, width, radius, x.device)
        x = torch.matmul(x.transpose(-1, -2), ww).transpose(-1, -2)
    if h != height:
        wh = lanczos_weights(h, height, radius, x.device)
        x = torch.matmul(x.movedim(-3, -1), wh).movedim(-1, -3)
    return x


def _torch_rung(image: np.ndarray, height: int, width: int) -> np.ndarray:
    out = lanczos_resize(torch.from_numpy(np.ascontiguousarray(image)).float(),
                         height, width, radius=5)
    return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def lanczos_resize_uint8(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize an HxWxC uint8 image to (height, width) with Lanczos-family
    interpolation, degrading cv2 -> native C++ -> torch (JAX's lanczos5)."""
    if image.shape[:2] == (height, width):
        return image
    if cv2 is not None:
        _log_rung("cv2", f"cv2 {cv2.__version__} INTER_LANCZOS4")
        # cv2 takes (width, height)
        return cv2.resize(image, (width, height), interpolation=cv2.INTER_LANCZOS4)
    from blurr_tpu_torch import native

    if native.available():
        out = native.lanczos4_resize(image, (height, width))
        if out is not None:
            _log_rung("native", f"native/preprocess.cpp built at {native.library_path()}")
            return out
    _log_rung("torch", "jax.image.resize lanczos5 in fp32 on the host")
    return _torch_rung(image, height, width)
