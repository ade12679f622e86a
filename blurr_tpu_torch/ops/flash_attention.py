"""Fused flash attention for the joint prefill: a CUDA kernel for Hopper.

Counterpart of ``blurr_tpu/ops/pallas_attention.py:flash_attention``. The
kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel
``blurr_tpu/ops/pallas_attention.py:_attn_kernel`` and computes the same
function: GQA attention with fp32 logits scaled by d^-0.5, the tanh soft
clamp, a boolean mask with a ``finfo(float32).min`` fill, an fp32 online
softmax with ``l`` floored at 1e-30, and the output in ``q.dtype``.

What bounds it on the H100, and the design: one Pi-0 prefill layer
(q [1,8,277,256] over k/v [1,1,277,256]) is ~0.63 GFLOP over ~2.6 MB, near
the bf16 ridge, but at batch 1 it is bound by latency and occupancy. The
kernel runs one block per (batch, query head, 16-query tile), 144 blocks at
that shape, about one per SM, and streams 32-key tiles of K/V through
shared memory with fp32 FMAs. It handles the ragged 277 with bounds checks
instead of the JAX wrapper's padding to 128. Tensor cores (wgmma), TMA and
pipelining are later work.

``flash_attention`` launches the kernel for CUDA tensors, and uses the
plain version ``flash_attention_reference`` only for CPU tensors. It counts
its kernel launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from blurr_tpu_torch.ops import kernels
from blurr_tpu_torch.ops.attention import DEFAULT_SOFTCLAMP, grouped_attention

HEAD_DIMS = (32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    softclamp: Optional[float] = DEFAULT_SOFTCLAMP,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version (same signature and result)."""
    return grouped_attention(q, k, v, mask, softclamp, scale)


def _check(q, k, v, mask) -> None:
    """What the kernel takes; anything else raises (nothing is copied)."""
    tensors = (q, k, v) if mask is None else (q, k, v, mask)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and mask lie on different devices: {devices}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D [B, heads, S, D]")
    b, nh, sq, d = q.shape
    kb, kvh, skv, kd = k.shape
    if kb != b or kd != d or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not match [B,NH,Sq,D] / [B,KVH,Skv,D]"
        )
    if nh % kvh:
        raise ValueError(f"{nh} query heads do not group over {kvh} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported (one of {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: q, k and v must share "
            "float32 or bfloat16"
        )
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (b, sq, skv):
            raise ValueError(
                f"mask must be bool [{b}, {sq}, {skv}], got {mask.dtype} "
                f"{tuple(mask.shape)}"
            )
    for name, t in zip("qkvm", tensors):
        if not t.is_contiguous():
            raise ValueError(f"{'mask' if name == 'm' else name} is not contiguous")


def flash_attention(
    q: torch.Tensor,  # [B, NH, Sq, D]
    k: torch.Tensor,  # [B, KVH, Skv, D]
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # bool [B, Sq, Skv]
    softclamp: Optional[float] = DEFAULT_SOFTCLAMP,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, NH, Sq, D] in ``q.dtype``. CUDA tensors launch the kernel
    on the current stream (no synchronisation); CPU tensors run the plain
    version."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask, softclamp, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not {q.device}")
    b, nh, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, nh, kvh, sq, skv, d, _DTYPE_CODES[q.dtype],
            float(scale), float(softclamp or 0.0), stream,
        )
    if err:
        msg = lib.blurr_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention")
    fn = lib.blurr_flash_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
