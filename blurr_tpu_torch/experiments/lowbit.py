"""The weight layouts of the low-bit matmul experiments, and the port's
counterpart of each of their kernels.

The JAX experiments (``experiments/bench_pallas_int4*.py``,
``experiments/bench_pallas_int8_blockmajor.py``) try one function several
ways on the TPU. The layouts here give their bytes exactly:

- ``pack_split_half``: byte [k, n] holds row k in the low nibble and row
  k + K/2 in the high one (``bench_pallas_int4.py:87``);
- ``pack_split_half_biased``: the same with nibbles q + 8
  (``bench_pallas_int4_tune2.py:129-130``);
- the adjacent-row packing of ``pltpu.bitcast`` to int4 (row 2k in the low
  nibble) is ``ops/int4_matmul.pack_int4``, K2's own;
- ``int8_block_major``: [K, N] -> [N/BN, K, BN]
  (``bench_pallas_int8_blockmajor.py:99``).

The functions map to three kernels: the w8a8 product to K4
(``ops/w8a8_matmul.py``), the split-half int4 product to K5
(``ops/int4_split_matmul.py``), and the adjacent-row int4 product, with one
scale per column, to K2 (``ops/int4_matmul.py``) with one group over the whole
of K: ``int4_adjacent_matmul``.
"""

from __future__ import annotations

import torch

from blurr_tpu_torch.ops.int4_matmul import int4_matmul, pick_block_layout, to_block_major


def _pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int4 row blocks (values in 0..15 or -8..7) into one byte each."""
    return ((lo.to(torch.int32) & 0x0F) | ((hi.to(torch.int32) & 0x0F) << 4)).to(torch.int8)


def pack_split_half(q: torch.Tensor) -> torch.Tensor:
    """int8 [..., K, N] with values in [-8, 7] -> packed int8 [..., K//2, N]:
    byte [k, n] holds row k in the low nibble and row k + K/2 in the high."""
    k = q.shape[-2]
    if k % 2:
        raise ValueError(f"K must be even to pack halves, got {tuple(q.shape)}")
    return _pack(q[..., : k // 2, :], q[..., k // 2 :, :])


def pack_split_half_biased(q: torch.Tensor) -> torch.Tensor:
    """As ``pack_split_half``, with each nibble holding q + 8 (0 .. 15)."""
    return pack_split_half(q + 8)


def int8_block_major(w: torch.Tensor, block_n: int) -> torch.Tensor:
    """int8 [..., K, N] -> block-major [..., N//block_n, K, block_n]
    (contiguous): each block of columns is one contiguous chunk."""
    *lead, k, n = w.shape
    if n % block_n:
        raise ValueError(f"N={n} is not a multiple of block_n={block_n}")
    return w.reshape(*lead, k, n // block_n, block_n).movedim(-2, -3).contiguous()


def adjacent_block_width(n: int) -> int:
    """The block width K2 takes an adjacent-row packed [K/2, N] weight in:
    ``pick_block_layout``'s, which must divide N (1408 for N 11264)."""
    bn, n_pad = pick_block_layout(n)
    if n_pad != n:
        raise ValueError(f"N={n} needs padding to {n_pad} for K2's blocks of {bn}")
    return bn


def int4_adjacent_matmul(x: torch.Tensor, packed: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32 [M, N] = float32(x @ unpack(packed)) * s for an adjacent-row
    packed int4 weight [K//2, N] (``pack_int4``) and scales s [1, N]: K2 at
    one group over the whole of K, on the weight re-laid block-major (a
    lossless copy)."""
    return int4_matmul(x, to_block_major(packed, adjacent_block_width(packed.shape[-1])), s)
