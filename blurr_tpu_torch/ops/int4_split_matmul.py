"""int4 x int8 matmul over the split-half packing: a CUDA kernel for Hopper.

The kernel, ``csrc/int4_split_matmul.cu``, replaces the TPU kernels of the
split-half w4a8 experiments (``experiments/bench_pallas_int4.py:_w4_kernel``,
``experiments/bench_pallas_int4_tune.py:_w4_kernel``,
``experiments/bench_pallas_int4_tune2.py:_w4_shift2`` and ``_w4_biased``) and
computes their function:

    out[M, N] = float32(x @ q) * s

with int8 activations x [M, K], int4 weights q [K, N] packed row-major
[K//2, N] (``experiments.lowbit.pack_split_half``: byte [k, n] holds row k in
the low nibble and row k + K/2 in the high one) and fp32 scales s [1, N].
With ``biased`` the nibbles hold q + 8 (``pack_split_half_biased``); the
harness subtracts 8 * rowsum(x) after its dots, which gives the same
integer. The dot is exact in int32 and rounds once to fp32 in the kernel and
in the plain version ``int4_split_matmul_reference`` alike: the two agree
bit for bit.

``int4_split_matmul`` launches the kernel for CUDA tensors, runs the plain
version only for CPU tensors, and counts its kernel launches in
``int4_split_matmul.launches``. The kernel is K4's int8 ``mma.sync`` path
(``csrc/w8a8_matmul.cu``) on the packed bytes: each fragment word of packed
rows is unpacked in registers into the B operands of both halves, fed by
``cp.async``, and where its tiles alone leave the card short it splits K/2
over a thread block cluster whose int32 partial dots add exactly before the
one conversion (the source's header); ``grid`` and ``slices`` give that
geometry. Nothing on the control step calls it.
"""

from __future__ import annotations

import ctypes

import torch

from blurr_tpu_torch.ops import kernels


def unpack_split_half_reference(packed: torch.Tensor, biased: bool = False) -> torch.Tensor:
    """packed int8 [K//2, N] -> int8 [K, N]: the low nibbles are rows
    0 .. K/2-1, the high nibbles rows K/2 .. K-1. Signed nibbles are
    sign-extended ((b & 0xF) ^ 8) - 8 and b >> 4; biased ones are n - 8."""
    p = packed.to(torch.int32)
    if biased:
        lo, hi = (p & 0x0F) - 8, ((p >> 4) & 0x0F) - 8
    else:
        lo, hi = ((p & 0x0F) ^ 0x08) - 0x08, p >> 4
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def int4_split_matmul_reference(x: torch.Tensor, packed: torch.Tensor, s: torch.Tensor,
                                biased: bool = False) -> torch.Tensor:
    """The kernel's plain PyTorch version: fp32 [M, N]. The dot is taken in
    float64, which holds it exactly, rounded to fp32 as the int32 -> fp32
    conversion rounds, then one fp32 multiply by the scale."""
    w = unpack_split_half_reference(packed, biased).to(torch.float64)
    d = x.to(torch.float64) @ w
    return d.to(torch.float32) * s.reshape(1, -1)


def _check(x, packed, s) -> None:
    """What the kernel takes; anything else raises (nothing is copied)."""
    devices = {x.device, packed.device, s.device}
    if len(devices) != 1:
        raise ValueError(f"x, packed and s lie on different devices: {devices}")
    if x.dim() != 2 or packed.dim() != 2 or s.dim() != 2:
        raise ValueError(
            "int4_split_matmul takes x [M, K], packed [K//2, N] and s [1, N]; got "
            f"{tuple(x.shape)}, {tuple(packed.shape)}, {tuple(s.shape)}"
        )
    m, k = x.shape
    k2, n = packed.shape
    if k != 2 * k2 or tuple(s.shape) != (1, n) or m < 1 or k2 < 1 or n % 4:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, s "
            f"{tuple(s.shape)}: need K = 2 * K//2 >= 2, s [1, N], M >= 1 and N a "
            "multiple of 4"
        )
    if x.dtype != torch.int8 or packed.dtype != torch.int8:
        raise ValueError(f"x and packed must be int8, got {x.dtype}, {packed.dtype}")
    if s.dtype != torch.float32:
        raise ValueError(f"s must be float32, got {s.dtype}")
    for name, t in (("x", x), ("packed", packed), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if packed.data_ptr() % 4:
        raise ValueError("packed must be 4-byte aligned (the kernel reads words)")


def int4_split_matmul(
    x: torch.Tensor,  # [M, K] int8
    packed: torch.Tensor,  # [K//2, N] int8, split-half nibble-packed int4
    s: torch.Tensor,  # [1, N] fp32
    biased: bool = False,
) -> torch.Tensor:
    """Returns fp32 [M, N] = float32(x @ unpack(packed)) * s. CUDA tensors
    launch the kernel on the current stream (no synchronisation); CPU tensors
    run the plain version."""
    _check(x, packed, s)
    if x.device.type == "cpu":
        return int4_split_matmul_reference(x, packed, s, biased)
    if x.device.type != "cuda":
        raise ValueError(f"int4_split_matmul runs on CUDA or CPU, not {x.device}")
    m, k = x.shape
    n = packed.shape[1]
    lib = _library()
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_int4_split_matmul(
            x.data_ptr(), packed.data_ptr(), s.data_ptr(), out.data_ptr(),
            m, k, n, int(biased), stream,
        )
    if err:
        msg = lib.blurr_cuda_error_string(err).decode()
        raise RuntimeError(f"int4_split_matmul kernel launch failed: {msg} ({err})")
    int4_split_matmul.launches += 1
    return out


int4_split_matmul.launches = 0


def grid(m: int, k: int, n: int) -> tuple:
    """The kernel's grid for an (M, K, N) product, signed or biased alike:
    (column tiles of 64, or of 128 above 64 rows; S slices of K/2; row
    blocks of up to 144 rows); S is also the cluster size. Builds the
    kernel."""
    out = (ctypes.c_int * 3)()
    err = _library().blurr_int4_split_matmul_grid(m, k, n, 0, out)
    if err:
        raise ValueError(f"int4_split_matmul takes no (M, K, N) = {(m, k, n)}")
    return tuple(out)


def slices(m: int, k: int, n: int) -> int:
    """S, the slices of K/2 the kernel splits an (M, K, N) product into.
    Builds the kernel."""
    return grid(m, k, n)[1]


def _library() -> ctypes.CDLL:
    lib = kernels.load("int4_split_matmul")
    fn = lib.blurr_int4_split_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.blurr_int4_split_matmul_grid.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.blurr_int4_split_matmul_grid.restype = i
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
