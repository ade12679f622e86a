"""The arithmetic of K5, the split-half int4 kernel
(``csrc/int4_split_matmul.cu``), mirrored in numpy and held against the
plain version on the CPU.

The kernel cannot run here, so what it does between the packed bytes in
memory and the mma is written out lane by lane and checked, with K4's
mirrored staging, ``ldmatrix``, byte permutes and mma
(``tests/test_torch_w8a8_matmul.py``):
- the unpack: each nibble of a fragment word moved to the top of its byte
  (the biased packing's first turned into two's complement by ``^ 8``) is
  16 q as int8, the low nibbles the low half's B word, the high nibbles the
  high half's, for every byte;
- one 32-row step: the packed rows staged permuted, ``ldmatrix.x4.trans``,
  the two byte permutes, both unpacks and two mma m16n8k32 (one with x's
  low half, one with its high half) equal ``16 * x.astype(int64) @ q``
  exactly;
- the split of K/2: S slices of ceil(K/2 / S) packed rows rounded up to 32,
  each walked in chunks of 128 and steps of 32 with both halves of x zero
  past the slice, each chunk's sum of 16 q x shifted right by 4 into an
  int32 partial dot; the partials, added in any order and converted once,
  equal ``int4_split_matmul_reference`` bit for bit.

The kernel itself is held against the plain version on the card by the
``cuda`` tests of ``tests/test_torch_experiments.py`` and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from blurr_tpu_torch.experiments import lowbit
from blurr_tpu_torch.ops import int4_split_matmul as t_split
from tests.test_torch_w8a8_matmul import (
    _byte_perm,
    _bytes,
    _ldmatrix_x4,
    _ldmatrix_x4_trans,
    _mma_m16n8k32,
    _staged_row,
    GID,
    TIG,
)

CHUNK = 128  # packed rows (of K/2) the kernel stages at once


def _unpack16(word, biased):
    """The kernel's unpack16: a word of packed bytes -> (low half's B word,
    high half's B word), each byte 16 q as int8."""
    if biased:
        word = word ^ np.uint32(0x88888888)
    return (word << np.uint32(4)) & np.uint32(0xF0F0F0F0), word & np.uint32(0xF0F0F0F0)


def _pack(q, biased):
    pack = lowbit.pack_split_half_biased if biased else lowbit.pack_split_half
    return pack(torch.from_numpy(q)).numpy()


def _unpacked(packed, biased):
    return t_split.unpack_split_half_reference(torch.from_numpy(packed), biased).numpy()


@pytest.mark.parametrize("biased", [False, True])
def test_word_unpack_is_16_times_the_reference_for_every_byte(biased):
    """All 256 packed byte values, four to a word in every byte position:
    the low-half and the high-half words are 16 times
    unpack_split_half_reference's rows k and k + K/2, as int8."""
    values = np.arange(256, dtype=np.uint8)
    for shift in range(4):  # each value in each byte of a word
        packed = np.roll(values, shift).reshape(64, 4)
        words = packed.view("<u4")[:, 0].astype(np.uint32)
        lo, hi = _unpack16(words, biased)
        want = 16 * _unpacked(packed.reshape(1, 256).view(np.int8), biased)  # [2, 256]
        np.testing.assert_array_equal(_bytes(lo).reshape(-1), want[0])
        np.testing.assert_array_equal(_bytes(hi).reshape(-1), want[1])


def _mirrored_step(x_tile, packed_tile, biased):
    """One warp's 32-row step of packed rows over a 16-byte column run, as
    the kernel runs it: packed_tile [32, 16] staged permuted, x_tile [16, 64]
    its low half (columns 0-31) and high half (32-63) staged as they lie.
    Returns the [16, 16] int dots of x and 16 q as the lanes hold them (lane
    (g, t), dot(h, i): row g + 8h, column 4t + i)."""
    staged = np.zeros_like(packed_tile)
    staged[_staged_row(np.arange(32))] = packed_tile
    b = _ldmatrix_x4_trans(staged, 0)
    a_lo, a_hi = _ldmatrix_x4(x_tile[:, :32]), _ldmatrix_x4(x_tile[:, 32:])
    d = []
    for sel in (0x6420, 0x7531):  # even, odd columns
        halves = [_unpack16(_byte_perm(b[2 * h], b[2 * h + 1], sel), biased) for h in range(2)]
        lo = (halves[0][0], halves[1][0])
        hi = (halves[0][1], halves[1][1])
        d.append(_mma_m16n8k32(a_lo, *lo) + _mma_m16n8k32(a_hi, *hi))
    out = np.zeros((16, 16), np.int64)
    for lane, (g, t) in enumerate(zip(GID, TIG)):
        for h in range(2):
            for i in range(4):  # dots[2 p + (i & 1)][2 h + i / 2]
                out[g + 8 * h, 4 * t + i] = d[i & 1][lane, 2 * h + i // 2]
    return out


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirrored_step_equals_the_int64_product(seed, biased):
    """Random int8 x [16, 64] and int4 q [64, 16], packed split-half: the
    mirrored staging, ldmatrix, byte permutes, unpacks and both mma give
    exactly 16 x @ q in int64, and x @ q shifted right by 4."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (16, 64)).astype(np.int8)
    q = rng.randint(-8, 8, (64, 16)).astype(np.int8)
    packed = _pack(q, biased)
    np.testing.assert_array_equal(_unpacked(packed, biased), q)
    got, want = _mirrored_step(x, packed, biased), x.astype(np.int64) @ q
    np.testing.assert_array_equal(got, 16 * want)
    np.testing.assert_array_equal(got >> 4, want)


@pytest.mark.parametrize("biased", [False, True])
def test_mirrored_step_at_the_int8_and_int4_extremes(biased):
    """-128 and 127 in x, -8 and 7 in q, in every position pattern: no
    nibble is sign-extended wrongly or mixed with a neighbour's."""
    rng = np.random.RandomState(9)
    x = rng.choice(np.array([-128, 127, -1, 0], np.int8), (16, 64))
    q = rng.choice(np.array([-8, 7, -1, 0], np.int8), (64, 16))
    packed = _pack(q, biased)
    got, want = _mirrored_step(x, packed, biased), x.astype(np.int64) @ q
    np.testing.assert_array_equal(got, 16 * want)
    np.testing.assert_array_equal(got >> 4, want)


def _part_rows(k2, slices):
    """Packed rows in each slice: ceil(K/2 / S) rounded up to 32, as the
    kernel's part_rows."""
    return -(-(-(-k2 // slices)) // 32) * 32


def _split_mirror(x, packed, s, slices, order, biased):
    """The kernel's split in numpy: slice i covers packed rows [i P,
    min(K/2, (i + 1) P)) (the last slices may be short or empty), walked in
    chunks of 128 and steps of 32 with both halves of x zero past the slice;
    each chunk's sum of x and 16 q (within 2**22) is shifted right by 4 into
    an int32 partial dot; the partials are added in ``order`` (int32, exact)
    and converted to fp32 once, then one fp32 multiply by the scale."""
    m, k = x.shape
    k2 = k // 2
    part = _part_rows(k2, slices)
    q = 16 * _unpacked(packed, biased).astype(np.int64)
    w_lo, w_hi = q[:k2], q[k2:]
    x_lo, x_hi = x[:, :k2].astype(np.int64), x[:, k2:].astype(np.int64)
    partials = []
    for i in range(slices):
        a, b = min(k2, i * part), min(k2, (i + 1) * part)
        dot = np.zeros((m, q.shape[1]), np.int64)
        for c0 in range(a, b, CHUNK):
            chunk = np.zeros_like(dot)
            for k0 in range(c0, min(b, c0 + CHUNK), 32):
                rows = min(32, b - k0)  # x zero past the slice
                for xs, ws in ((x_lo, w_lo), (x_hi, w_hi)):
                    step = np.zeros((m, 32), np.int64)
                    step[:, :rows] = xs[:, k0:k0 + rows]
                    w_step = np.zeros((32, q.shape[1]), np.int64)
                    w_step[:min(32, k2 - k0)] = ws[k0:min(k2, k0 + 32)]  # rows past b meet zeros
                    chunk += step @ w_step
            assert np.abs(chunk).max() <= 2**22 and not (chunk % 16).any()
            dot += chunk >> 4
        assert np.abs(dot).max() < 2**31
        partials.append(dot.astype(np.int32))
    total = np.zeros_like(partials[0])
    for i in order:
        total = total + partials[i]  # int32: exact, the whole dot is within int32
    return total.astype(np.float32) * s


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("m,k,n,slices", [
    (3, 38, 8, 1),        # K/2 19: one short step, K/2 odd
    (3, 38, 8, 16),       # K/2 19 over 16 slices: 15 empty
    (5, 200, 12, 2),      # K/2 100: slices of 64 and a short 36
    (5, 192, 12, 4),      # K/2 96: slices of 32, 32, 32 and an empty last one
    (2, 200, 8, 16),      # slices of 32: four used, twelve empty
    (8, 4096, 16, 2),     # the (8, 4096, 11264) split
    (2, 32768, 8, 16),    # the largest S, and dots past 2**24
])
def test_split_mirror_equals_reference(m, k, n, slices, biased):
    """int32 partial dots per slice of K/2, added in a shuffled order and
    converted once: bit-equal to int4_split_matmul_reference, with scales
    that are not 1 and, at K 32768, a column of dots past 2**24."""
    rng = np.random.RandomState(m * k + slices)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    q = rng.randint(-8, 8, (k, n)).astype(np.int8)
    x[0] = -128
    q[:, 0] = -8  # x[0] . q[:, 0] = 1024 K: past 2**24 at K > 16384
    s = (rng.rand(1, n) * 1e-2 + 1e-4).astype(np.float32)
    packed = _pack(q, biased)
    got = _split_mirror(x, packed, s, slices, rng.permutation(slices), biased)
    want = t_split.int4_split_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(s), biased)
    np.testing.assert_array_equal(got, want.numpy())
    if k > 16384:
        assert 1024 * k > 2**24
