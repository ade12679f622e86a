"""int8 x int8 matmul with per-column fp32 scales (w8a8): a CUDA kernel for
Hopper.

The kernel, ``csrc/w8a8_matmul.cu``, replaces the TPU kernels of the w8a8
experiments (``experiments/bench_pallas_int4.py:_int8_kernel``,
``experiments/bench_pallas_int4_tune.py:_int8_kernel`` and
``experiments/bench_pallas_int8_blockmajor.py:_kernel``) and computes their
function:

    out[M, N] = float32(x @ w) * s

with int8 activations x [M, K], int8 weights w either row-major [K, N] or
block-major [NB, K, BN] (``experiments.lowbit.int8_block_major``), and fp32
scales s [1, N]. The dot is exact in int32 (|x @ w| < 2**31 for K < 2**17);
its conversion to fp32 rounds once, to nearest even, in the kernel and in the
plain version ``w8a8_matmul_reference`` alike, so the two agree bit for bit.

``w8a8_matmul`` launches the kernel for CUDA tensors, runs the plain version
only for CPU tensors, and counts its kernel launches in
``w8a8_matmul.launches``. The kernel runs int8 ``mma.sync`` on the tensor
cores, fed by ``cp.async``, and where its tiles alone leave the card short it
splits K over a thread block cluster whose int32 partial dots add exactly
before the one conversion (the source's header); ``grid`` and ``slices`` give
that geometry. Nothing on the control step calls it: JAX leaves
the w8a8 product to XLA, and the port to ``torch._int_mm`` (``ops/quant.py``).
"""

from __future__ import annotations

import ctypes

import torch

from blurr_tpu_torch.ops import kernels


def _row_major(w: torch.Tensor) -> torch.Tensor:
    """w [K, N] as it is, or block-major [NB, K, BN] -> [K, NB*BN]."""
    if w.dim() == 2:
        return w
    nb, k, bn = w.shape
    return w.movedim(0, 1).reshape(k, nb * bn)


def w8a8_matmul_reference(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: fp32 [M, N]. The dot is taken in
    float64, which holds it exactly, then rounded to fp32 as the int32 ->
    fp32 conversion rounds, then one fp32 multiply by the scale."""
    d = x.to(torch.float64) @ _row_major(w).to(torch.float64)
    return d.to(torch.float32) * s.reshape(1, -1)


def _check(x, w, s) -> None:
    """What the kernel takes; anything else raises (nothing is copied)."""
    devices = {x.device, w.device, s.device}
    if len(devices) != 1:
        raise ValueError(f"x, w and s lie on different devices: {devices}")
    if x.dim() != 2 or w.dim() not in (2, 3) or s.dim() != 2:
        raise ValueError(
            "w8a8_matmul takes x [M, K], w [K, N] or [NB, K, BN] and s [1, N]; "
            f"got {tuple(x.shape)}, {tuple(w.shape)}, {tuple(s.shape)}"
        )
    m, k = x.shape
    if w.dim() == 2:
        kw, n = w.shape
        bn = n
    else:
        nb, kw, bn = w.shape
        n = nb * bn
    if k != kw or tuple(s.shape) != (1, n) or m < 1 or not 1 <= k < 2**17 or bn % 4:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, s {tuple(s.shape)}: "
            "need the same K (1 <= K < 2**17: the int32 dot), s [1, N], M >= 1 "
            "and BN a multiple of 4"
        )
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    if s.dtype != torch.float32:
        raise ValueError(f"s must be float32, got {s.dtype}")
    for name, t in (("x", x), ("w", w), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if w.data_ptr() % 4:
        raise ValueError("w must be 4-byte aligned (the kernel reads words)")


def w8a8_matmul(
    x: torch.Tensor,  # [M, K] int8
    w: torch.Tensor,  # [K, N] or block-major [NB, K, BN] int8
    s: torch.Tensor,  # [1, N] fp32
) -> torch.Tensor:
    """Returns fp32 [M, N] = float32(x @ w) * s. CUDA tensors launch the
    kernel on the current stream (no synchronisation); CPU tensors run the
    plain version."""
    _check(x, w, s)
    if x.device.type == "cpu":
        return w8a8_matmul_reference(x, w, s)
    if x.device.type != "cuda":
        raise ValueError(f"w8a8_matmul runs on CUDA or CPU, not {x.device}")
    m, k = x.shape
    n = s.shape[1]
    bn = n if w.dim() == 2 else w.shape[2]  # row-major is one block of N
    lib = _library()
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_w8a8_matmul(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n, bn, stream,
        )
    if err:
        msg = lib.blurr_cuda_error_string(err).decode()
        raise RuntimeError(f"w8a8_matmul kernel launch failed: {msg} ({err})")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0


def grid(m: int, k: int, n: int, bn: int) -> tuple:
    """The kernel's grid for an (M, K, N) product with blocks of BN columns:
    (column tiles of 64, or of 128 above 64 rows; S slices of K; row blocks
    of up to 144 rows); S is also the cluster size. Builds the kernel."""
    out = (ctypes.c_int * 3)()
    err = _library().blurr_w8a8_matmul_grid(m, k, n, bn, out)
    if err:
        raise ValueError(f"w8a8_matmul takes no (M, K, N, BN) = {(m, k, n, bn)}")
    return tuple(out)


def slices(m: int, k: int, n: int, bn: int) -> int:
    """S, the slices of K the kernel splits an (M, K, N) product into.
    Builds the kernel."""
    return grid(m, k, n, bn)[1]


def _library() -> ctypes.CDLL:
    lib = kernels.load("w8a8_matmul")
    fn = lib.blurr_w8a8_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.blurr_w8a8_matmul_grid.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.blurr_w8a8_matmul_grid.restype = i
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
