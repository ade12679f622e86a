"""Int8 weight-only dequant-matmul for the int8 tier: a CUDA kernel for Hopper.

Counterpart of ``blurr_tpu/ops/pallas_int8_matmul.py``. The kernel,
``csrc/int8_matmul.cu``, replaces the TPU kernel
``blurr_tpu/ops/pallas_int8_matmul.py:_kernel`` (wrappers ``int8_matmul``
and ``int8_mm_nd``) and computes the same function:

    out[M, N] = x.dtype((sum_k bf16(x[m, k]) * q[k, n]) * s[n])

with x [M, K] fp32 or bf16, q int8 [K, N] row-major (the JAX layout, so a
JAX-quantized weight copies over as it is) and s fp32 [N]. The sum is taken
in fp32; the scale is applied once, after it, then the cast. Each product
of a bf16 value and an int8 value is exact in fp32, so the kernel and the
plain version ``int8_matmul_reference`` (which sums in float64 and rounds
once) differ only by the kernel's fp32 summation error.

The kernel splits K into S slices, one block each, that sum on bf16 tensor
cores in fp32; the S blocks of a tile form a thread block cluster and add
their sums in slice order through distributed shared memory (the source's
header gives the design). ``int8_matmul`` launches it for CUDA tensors,
runs the plain version only for CPU tensors, and counts its kernel launches
in ``int8_matmul.launches``; ``slices`` gives S for a shape.
``int8_mm_nd`` flattens the leading axes of x.
"""

from __future__ import annotations

import ctypes

import torch

from blurr_tpu_torch.ops import kernels

_X_DTYPES = (torch.float32, torch.bfloat16)


def int8_matmul_reference(
    x: torch.Tensor,  # [M, K] fp32 or bf16
    q: torch.Tensor,  # [K, N] int8
    s: torch.Tensor,  # [N] fp32
) -> torch.Tensor:
    """The kernel's plain PyTorch version: x.dtype [M, N]. x is rounded to
    bf16, the products summed in float64 and rounded to fp32, then scaled
    in fp32 and cast."""
    acc = x.to(torch.bfloat16).to(torch.float64) @ q.to(torch.float64)
    return (acc.to(torch.float32) * s).to(x.dtype)


def _check(x, q, s) -> None:
    """What the kernel takes; anything else raises (nothing is copied)."""
    devices = {x.device, q.device, s.device}
    if len(devices) != 1:
        raise ValueError(f"x, q and s lie on different devices: {devices}")
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1:
        raise ValueError(
            f"int8_matmul takes x [M, K], q [K, N] and s [N]; got "
            f"{tuple(x.shape)}, {tuple(q.shape)}, {tuple(s.shape)}"
        )
    (m, k), (k2, n) = x.shape, q.shape
    if k != k2 or s.shape[0] != n or m < 1 or k < 1 or n < 1:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)}: "
            "need x [M, K], q [K, N], s [N], none of them empty"
        )
    if x.dtype not in _X_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {q.dtype}")
    if s.dtype != torch.float32:
        raise ValueError(f"s must be float32, got {s.dtype}")
    for name, t in (("x", x), ("q", q), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def int8_matmul(
    x: torch.Tensor,  # [M, K] fp32 or bf16
    q: torch.Tensor,  # [K, N] int8
    s: torch.Tensor,  # [N] fp32 per-out-channel scales
) -> torch.Tensor:
    """Returns x.dtype [M, N] = x.dtype((bf16(x) @ q) * s), summed in fp32.
    CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors run the plain version."""
    _check(x, q, s)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on CUDA or CPU, not {x.device}")
    m, k = x.shape
    n = q.shape[1]
    lib = _library()
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_int8_matmul(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
            m, k, n, int(x.dtype == torch.bfloat16), stream,
        )
    if err:
        msg = lib.blurr_cuda_error_string(err).decode()
        raise RuntimeError(f"int8_matmul kernel launch failed: {msg} ({err})")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_mm_nd(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [..., K] @ {"q": int8 [K, N], "s": fp32 [N]} -> [..., N] through
    ``int8_matmul`` over the flattened leading axes."""
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q"], w["s"])
    return y.reshape(*x.shape[:-1], y.shape[-1])


def slices(m: int, k: int, n: int) -> int:
    """S, the slices of K (and the cluster size) the kernel splits an (M, K,
    N) product into: the grid is N/64 column tiles x S x M/16 row tiles.
    Builds the kernel."""
    return _library().blurr_int8_matmul_slices(m, k, n)


def _library() -> ctypes.CDLL:
    lib = kernels.load("int8_matmul")
    fn = lib.blurr_int8_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.blurr_int8_matmul_slices.argtypes = [i, i, i]
        lib.blurr_int8_matmul_slices.restype = i
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
