"""Fused flash attention for the joint prefill: a CUDA kernel for Hopper.

Counterpart of ``blurr_tpu/ops/pallas_attention.py:flash_attention``. The
kernel, ``csrc/flash_attention.cu``, replaces the TPU kernel
``blurr_tpu/ops/pallas_attention.py:_attn_kernel`` and computes the same
function: GQA attention with fp32 logits scaled by d^-0.5, the tanh soft
clamp, a boolean mask with a ``finfo(float32).min`` fill, an fp32 online
softmax with ``l`` floored at 1e-30, and the output in ``q.dtype``. Keys
past Skv take no part, so a fully masked row averages V over the Skv keys,
as the plain version does (the TPU kernel's padded keys join that average).

One entry point, two kernels by dtype, both on the tensor cores (the
source's header gives the design): the query heads of a KV group are
folded into rows, so a block of 64 rows reads each K/V tile once for all
heads, and the keys are split into parts whose (m, l, O) merge in a fixed
order inside a thread block cluster. bf16, the served prefill, takes
``mma.sync`` m16n8k16 and rounds P to bf16 for P V, as the plain version
rounds its softmax weights. fp32 (the baseline preset's naive step, 180
launches a control step; the fp32 prefix-cache prefill) takes 3xTF32
``mma.sync`` m16n8k8: each fp32 operand is split into a TF32 high part and
a TF32 residual, and three products keep the output within 1e-5 of the
plain fp32 version, P in fp32 as the TPU kernel keeps it; it is bound by
operations at 165 TFLOP/s (495 TF32 over three products). Its times on an
H100 stand in PERF.md, row 1. ``grid`` gives a call's launch geometry.

``flash_attention`` launches the kernel for CUDA tensors, and uses the
plain version ``flash_attention_reference`` only for CPU tensors. It counts
its kernel launches in ``flash_attention.launches``, one per call.
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned (16-byte copies)")
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


def grid(b: int, nh: int, kvh: int, sq: int, skv: int, d: int, dtype: torch.dtype):
    """The launch geometry of a call: ``(grid, part_keys)``. The grid is
    (64-row tiles of the nh / kvh * sq folded rows, key parts, b * kvh); the
    key parts of a row tile form one cluster and hold ``part_keys`` keys
    each (the last one fewer). bf16 takes the most parts that keep one wave
    of one block per SM; fp32 the count that minimizes waves times a
    block's 32-key tiles plus one. Builds the kernel (the split depends on
    the current card's SM count)."""
    if d not in HEAD_DIMS or dtype not in _DTYPE_CODES:
        raise ValueError(f"no kernel for head_dim {d} and {dtype}")
    out = (ctypes.c_int * 4)()
    err = _library().blurr_flash_attention_grid(b, nh, kvh, sq, skv, _DTYPE_CODES[dtype], out)
    if err:
        raise ValueError(f"no launch for b={b} nh={nh} kvh={kvh} sq={sq} skv={skv}")
    return (out[0], out[1], out[2]), out[3]


def _library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention")
    fn = lib.blurr_flash_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        lib.blurr_flash_attention_grid.argtypes = [i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.blurr_flash_attention_grid.restype = i
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
