"""Group-wise int4 x int8 matmul for the w4a8 tier: a CUDA kernel for Hopper.

Counterpart of ``blurr_tpu/ops/pallas_int4_matmul.py``. The kernel,
``csrc/int4_matmul.cu``, replaces the TPU kernel
``blurr_tpu/ops/pallas_int4_matmul.py:_kernel`` (wrapper ``int4_matmul``)
and computes the same function:

    out[M, NB*BN] = sum_g float(x[:, g] @ unpack(packed)[g]) * scale[g]

with int8 activations x [M, K], nibble-packed int4 weights stored
block-major [NB, K//2, BN] (``pack_int4`` then ``to_block_major``), and fp32
scales [G, NB*BN] for G groups of K/G rows. Each group's dot is exact in
int32; the group terms are summed in fp32 in group order, one multiply and
one add per group (no fused multiply-add), so the kernel and the plain
version ``int4_matmul_reference`` agree bit for bit.

The layout helpers (``pick_block_layout``, ``pack_int4``, ``to_block_major``,
``pick_group_size``, ``unpack_int4_reference``, ``from_block_major``) keep the
JAX package's byte layout, so a JAX-quantized weight copies over as it is.
The tensor-parallel rule (JAX ``int4_matmul_spmd``: each rank runs the
kernel on its contiguous column blocks) is
``parallel/tensor_parallel.py:W4A8Blocks``.

The kernel runs int8 tensor cores on the nibbles unpacked in registers and
splits K into S slices, one block each, whose exact int32 partial dots meet
in one thread block cluster before the group epilogue (the source's header
gives the design). ``int4_matmul`` launches it for CUDA tensors (one launch
per call), runs the plain version only for CPU tensors, and counts its
kernel launches in ``int4_matmul.launches``; ``grid`` and ``slices`` give
the split for a shape.
"""

from __future__ import annotations

import ctypes

import torch

from blurr_tpu_torch.ops import kernels

# block widths tried by pick_block_layout, largest first (the JAX package's)
_BLOCK_WIDTHS = (1408, 1024, 512, 256, 128)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pick_block_layout(n: int, shards: int = 1) -> tuple:
    """(block_n, padded_n): the largest block whose zero padding stays under
    5%, else the block with the least padding. ``shards`` makes the padded
    width a multiple of ``block_n * shards`` (tensor-parallel packing)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    candidates = [(bn, _round_up(n, bn * shards)) for bn in _BLOCK_WIDTHS]
    for bn, n_pad in candidates:
        if n_pad <= n * 1.05:
            return bn, n_pad
    return min(candidates, key=lambda c: (c[1], -c[0]))


def pick_group_size(k: int, preferred: int = 512) -> int:
    """Largest divisor of k among (preferred, 256, 128); the whole of K (plain
    per-out-channel scaling) if none divides."""
    for g in (preferred, 256, 128):
        if k % g == 0 and k >= g:
            return g
    return k


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, N] with values in [-8, 7] -> packed int8 [..., K//2, N]:
    byte [k, n] holds row 2k in the low nibble and row 2k+1 in the high."""
    if q.shape[-2] % 2:
        raise ValueError(f"K must be even to pack int4 pairs, got {tuple(q.shape)}")
    lo = q[..., 0::2, :] & 0x0F
    hi = (q[..., 1::2, :] & 0x0F) << 4
    return (lo | hi).to(torch.int8)


def unpack_int4_reference(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: packed int8 [..., K//2, N] -> int8 [..., K, N].
    The low nibble is sign-extended as ((b & 0xF) ^ 8) - 8, the high nibble is
    the arithmetic shift b >> 4 of the signed byte."""
    p = packed.to(torch.int32)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4
    stacked = torch.stack([lo, hi], dim=-2)  # [..., K//2, 2, N]
    shape = (*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])
    return stacked.reshape(shape).to(torch.int8)


def to_block_major(packed: torch.Tensor, block_n: int) -> torch.Tensor:
    """packed [..., K//2, N] -> block-major [..., N//block_n, K//2, block_n]
    (contiguous), so each block of columns is one contiguous chunk."""
    *lead, k2, n = packed.shape
    if n % block_n:
        raise ValueError(f"N={n} is not a multiple of block_n={block_n}")
    blocks = packed.reshape(*lead, k2, n // block_n, block_n)
    return blocks.movedim(-2, -3).contiguous()


def from_block_major(packed_bm: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_block_major``: [..., NB, K//2, BN] -> [..., K//2, NB*BN]."""
    *lead, nb, k2, bn = packed_bm.shape
    return packed_bm.movedim(-3, -2).reshape(*lead, k2, nb * bn)


def int4_matmul_reference(
    x: torch.Tensor,  # [M, K] int8
    packed: torch.Tensor,  # [NB, K//2, BN] int8
    scale: torch.Tensor,  # [G, NB*BN] fp32
) -> torch.Tensor:
    """The kernel's plain PyTorch version: fp32 [M, NB*BN].

    The group dots are taken in float64, which holds them exactly (each is an
    integer of at most 128 * 8 * K/G in magnitude), then rounded to fp32 as
    the int32 -> fp32 conversion rounds. Each group term is a separate fp32
    multiply, and the terms are added in group order."""
    groups = scale.shape[0]
    k = x.shape[1]
    rows = k // groups
    w = unpack_int4_reference(from_block_major(packed)).to(torch.float64)
    xd = x.to(torch.float64)
    acc = None
    for g in range(groups):
        d = xd[:, g * rows : (g + 1) * rows] @ w[g * rows : (g + 1) * rows]
        term = d.to(torch.float32) * scale[g]
        acc = term if acc is None else acc + term
    return acc


def _check(x, packed, scale) -> None:
    """What the kernel takes; anything else raises (nothing is copied)."""
    devices = {x.device, packed.device, scale.device}
    if len(devices) != 1:
        raise ValueError(f"x, packed and scale lie on different devices: {devices}")
    if x.dim() != 2 or packed.dim() != 3 or scale.dim() != 2:
        raise ValueError(
            "int4_matmul takes x [M, K], packed [NB, K//2, BN] and scale "
            f"[G, NB*BN]; got {tuple(x.shape)}, {tuple(packed.shape)}, "
            f"{tuple(scale.shape)}"
        )
    m, k = x.shape
    nb, k2, bn = packed.shape
    groups, n = scale.shape
    if k != 2 * k2 or n != nb * bn or groups < 1 or k % groups:
        raise ValueError(
            f"shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, scale "
            f"{tuple(scale.shape)}: need K = 2 * K//2, N = NB * BN, G | K"
        )
    if m < 1 or bn % 16 or (k // groups) % 2:
        raise ValueError(
            f"M={m}, BN={bn}, K/G={k // groups}: need M >= 1, BN a multiple "
            "of 16 and an even number of rows per group"
        )
    if x.dtype != torch.int8 or packed.dtype != torch.int8:
        raise ValueError(f"x and packed must be int8, got {x.dtype}, {packed.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be float32, got {scale.dtype}")
    for name, t in (("x", x), ("packed", packed), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if packed.data_ptr() % 16:
        raise ValueError("packed must be 16-byte aligned (the kernel reads 16-byte vectors)")


def int4_matmul(
    x: torch.Tensor,  # [M, K] int8 (quantized activations)
    packed: torch.Tensor,  # [NB, K//2, BN] int8 (block-major nibble-packed int4)
    scale: torch.Tensor,  # [G, NB*BN] fp32 weight scales (padded N)
) -> torch.Tensor:
    """Returns fp32 [M, NB*BN] = sum_g (x_g @ unpack(packed)_g) * scale[g].
    CUDA tensors launch the kernel on the current stream (no
    synchronisation); CPU tensors run the plain version."""
    _check(x, packed, scale)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on CUDA or CPU, not {x.device}")
    m, k = x.shape
    bn = packed.shape[2]
    groups, n = scale.shape
    lib = _library()
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_int4_matmul(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, k, n, bn, groups, stream,
        )
    if err:
        msg = lib.blurr_cuda_error_string(err).decode()
        raise RuntimeError(f"int4_matmul kernel launch failed: {msg} ({err})")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0


def grid(m: int, k: int, n: int, groups: int) -> tuple:
    """The kernel's grid for an (M, K, N, G) product: (column tiles of 64,
    or of 128 above 64 rows; S slices of K; row blocks of up to 96 rows); S
    is also the cluster size. Builds the kernel."""
    out = (ctypes.c_int * 3)()
    err = _library().blurr_int4_matmul_grid(m, k, n, groups, out)
    if err:
        raise ValueError(f"int4_matmul takes no (M, K, N, G) = {(m, k, n, groups)}")
    return tuple(out)


def slices(m: int, k: int, n: int, groups: int) -> int:
    """S, the slices of K the kernel splits an (M, K, N, G) product into.
    Builds the kernel."""
    return grid(m, k, n, groups)[1]


def _library() -> ctypes.CDLL:
    lib = kernels.load("int4_matmul")
    fn = lib.blurr_int4_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.blurr_int4_matmul_grid.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.blurr_int4_matmul_grid.restype = i
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
