"""The arithmetic of K4, the w8a8 kernel (``csrc/w8a8_matmul.cu``), mirrored
in numpy and held against the plain version on the CPU.

The kernel cannot run here, so what it does between the bytes in memory and
the mma is written out lane by lane and checked:
- the fragment mapping: the weight's K rows staged permuted within each 16
  (``staged_row``), ``ldmatrix.x4.trans`` words of 16-bit elements, the two
  ``__byte_perm`` selectors that give each lane 4 consecutive K rows of an
  even and an odd column, ``ldmatrix.x4`` of x, and the m16n8k32 fragments as
  the PTX ISA lays them out; over all 32 lanes the mirrored mma equals
  ``x.astype(int64) @ w`` exactly;
- the split of K: S slices of ceil(K / S) rows rounded up to 32, each walked
  in chunks of 128 rows and steps of 32 with x zero past the slice, give
  int32 partial dots that, added in any order and converted once, equal
  ``w8a8_matmul_reference`` bit for bit.

The kernel itself is held against the plain version on the card by the
``cuda`` tests of ``tests/test_torch_experiments.py`` and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from blurr_tpu_torch.experiments import lowbit
from blurr_tpu_torch.ops import w8a8_matmul as t_w8a8

CHUNK = 128  # rows of K the kernel stages at once


def _staged_row(r):
    """The kernel's staged_row: K row 4t + j of each 16 goes to staged row
    2t + {0, 1, 8, 9}[j]."""
    return (r & ~15) | ((r >> 1) & 6) | ((r & 2) << 2) | (r & 1)


def _byte_perm(a, b, selector):
    """CUDA's __byte_perm(a, b, s): byte i of the result is byte
    (s >> 4 i) & 7 of the 8-byte value b:a."""
    pool = a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(a, dtype=np.uint32)
    for i in range(4):
        src = (selector >> (4 * i)) & 7
        out |= (((pool >> np.uint64(8 * src)) & np.uint64(0xFF)).astype(np.uint32)
                << np.uint32(8 * i))
    return out


def _bytes(word):
    """The 4 bytes of uint32 words as int8, byte 0 first: [..., 4]."""
    word = np.asarray(word, "<u4")
    return word.reshape(-1).view(np.uint8).reshape(*word.shape, 4).view(np.int8)


def _word(lo_pair, hi_pair):
    """A 32-bit register of two 16-bit elements, each 2 bytes [.., 2]."""
    b = np.concatenate([lo_pair, hi_pair], -1).astype(np.uint8)
    return b.view("<u4")[..., 0].astype(np.uint32)


LANES = np.arange(32)
GID, TIG = LANES // 4, LANES % 4


def _ldmatrix_x4_trans(staged, col0):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 with lane l addressing staged
    row l at byte col0: matrix i is staged rows 8i .. 8i + 7, 16 bytes, and
    lane (g, t) gets its elements [row 2t][col g] and [row 2t + 1][col g]
    (16-bit columns, so bytes 2g and 2g + 1). Returns 4 words per lane."""
    words = []
    for i in range(4):
        rows = staged[8 * i:8 * i + 8, col0:col0 + 16]
        lo = np.stack([rows[2 * t, 2 * g:2 * g + 2] for g, t in zip(GID, TIG)])
        hi = np.stack([rows[2 * t + 1, 2 * g:2 * g + 2] for g, t in zip(GID, TIG)])
        words.append(_word(lo, hi))
    return words


def _ldmatrix_x4(x_tile):
    """ldmatrix.sync.aligned.m8n8.x4.b16 of a [16, 32] x tile with lane l
    addressing row l % 16, bytes 16 (l / 16): matrix 0 rows 0-7 bytes 0-15,
    1 rows 8-15 bytes 0-15, 2 rows 0-7 bytes 16-31, 3 rows 8-15 bytes 16-31;
    lane (g, t) gets row g, 16-bit elements 2t and 2t + 1 of each."""
    words = []
    for i in range(4):
        r0, c0 = 8 * (i & 1), 16 * (i >> 1)
        rows = x_tile[r0:r0 + 8, c0:c0 + 16]
        lo = np.stack([rows[g, 4 * t:4 * t + 2] for g, t in zip(GID, TIG)])
        hi = np.stack([rows[g, 4 * t + 2:4 * t + 4] for g, t in zip(GID, TIG)])
        words.append(_word(lo, hi))
    return words


def _mma_m16n8k32(a, b0, b1):
    """mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 from the lanes'
    fragments as the PTX ISA lays them out: a0 holds A[g][4t + j], a1
    A[g + 8][4t + j], a2 A[g][16 + 4t + j], a3 A[g + 8][16 + 4t + j]; b0
    B[4t + j][g], b1 B[16 + 4t + j][g] (byte j). Returns each lane's d0..d3:
    D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane, (g, t) in enumerate(zip(GID, TIG)):
        ab = [_bytes(r[lane]) for r in a]
        A[g, 4 * t:4 * t + 4] = ab[0]
        A[g + 8, 4 * t:4 * t + 4] = ab[1]
        A[g, 16 + 4 * t:20 + 4 * t] = ab[2]
        A[g + 8, 16 + 4 * t:20 + 4 * t] = ab[3]
        B[4 * t:4 * t + 4, g] = _bytes(b0[lane])
        B[16 + 4 * t:20 + 4 * t, g] = _bytes(b1[lane])
    D = A @ B
    return np.stack([D[GID, 2 * TIG], D[GID, 2 * TIG + 1],
                     D[GID + 8, 2 * TIG], D[GID + 8, 2 * TIG + 1]], -1)


def _mirrored_step(x_tile, w_tile):
    """One warp's 32-row K step over a 16-byte column run, as the kernel runs
    it: w_tile [32, 16] staged permuted, x_tile [16, 32] staged as it lies.
    Returns the [16, 16] int dots as the lanes hold them (lane (g, t),
    dot(h, i): row g + 8h, column 4t + i)."""
    staged = np.zeros_like(w_tile)
    staged[_staged_row(np.arange(32))] = w_tile
    b = _ldmatrix_x4_trans(staged, 0)
    even = (_byte_perm(b[0], b[1], 0x6420), _byte_perm(b[2], b[3], 0x6420))
    odd = (_byte_perm(b[0], b[1], 0x7531), _byte_perm(b[2], b[3], 0x7531))
    a = _ldmatrix_x4(x_tile)
    d_even, d_odd = _mma_m16n8k32(a, *even), _mma_m16n8k32(a, *odd)
    out = np.zeros((16, 16), np.int64)
    for lane, (g, t) in enumerate(zip(GID, TIG)):
        for h in range(2):
            for i in range(4):  # dots[2 p + (i & 1)][2 h + i / 2]
                d = (d_even, d_odd)[i & 1]
                out[g + 8 * h, 4 * t + i] = d[lane, 2 * h + i // 2]
    return out


def test_staged_row_is_a_bijection_of_each_16_rows():
    for r0 in (0, 16, 112):
        rows = _staged_row(np.arange(r0, r0 + 16))
        assert sorted(rows.tolist()) == list(range(r0, r0 + 16))
    # K row 4t + j lands on staged row 2t + {0, 1, 8, 9}[j]
    t, j = np.divmod(np.arange(16), 4)
    np.testing.assert_array_equal(_staged_row(np.arange(16)), 2 * t + np.array([0, 1, 8, 9])[j])


def test_each_lane_gets_k_rows_in_order_for_both_columns():
    """B words after the byte permutes: byte j of lane (g, t)'s even word of
    half h is K row 16 h + 4 t + j of column 2g, of its odd word the same row
    of column 2g + 1; so over the lanes and bytes each K row of the 32-row
    step is met once per column (a bijection), in the order A takes it."""
    rows = np.arange(32)[:, None].repeat(16, 1)  # w[k][c] = k: the bytes name their row
    cols = np.arange(16)[None, :].repeat(32, 0)
    for labels, want in ((rows, lambda h, t, g, j, o: 16 * h + 4 * t + j),
                         (cols, lambda h, t, g, j, o: 2 * g + o)):
        staged = np.zeros((32, 16), np.int8)
        staged[_staged_row(np.arange(32))] = labels
        b = _ldmatrix_x4_trans(staged, 0)
        for h in range(2):
            for o, sel in enumerate((0x6420, 0x7531)):
                got = _bytes(_byte_perm(b[2 * h], b[2 * h + 1], sel))  # [32 lanes, 4]
                for lane, (g, t) in enumerate(zip(GID, TIG)):
                    assert [int(v) for v in got[lane]] == [want(h, t, g, j, o) for j in range(4)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mirrored_fragments_equal_the_int64_product(seed):
    """Random int8 x [16, 32] and w [32, 16] through the mirrored staging,
    ldmatrix, byte permutes and mma: exactly x @ w in int64."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (16, 32)).astype(np.int8)
    w = rng.randint(-128, 128, (32, 16)).astype(np.int8)
    np.testing.assert_array_equal(_mirrored_step(x, w), x.astype(np.int64) @ w)


def test_mirrored_fragments_at_the_int8_extremes():
    """-128 and 127 in every position pattern: no byte is sign-extended or
    mixed with a neighbour's."""
    rng = np.random.RandomState(9)
    x = rng.choice(np.array([-128, 127, -1, 0], np.int8), (16, 32))
    w = rng.choice(np.array([-128, 127, -1, 1], np.int8), (32, 16))
    np.testing.assert_array_equal(_mirrored_step(x, w), x.astype(np.int64) @ w)


def _part_rows(k, slices):
    """Rows of K in each slice: ceil(K / S) rounded up to 32, as the kernel's
    part_rows."""
    return -(-(-(-k // slices)) // 32) * 32


def _split_mirror(x, w, s, slices, order):
    """The kernel's split in numpy: slice i covers K rows [i P, min(K, (i + 1)
    P)) (P from _part_rows; the last slices may be short or empty), walked in
    chunks of 128 rows and steps of 32 with x zero past the slice, giving an
    int32 partial dot; the partials are added in ``order`` (int32, exact)
    and converted to fp32 once, then one fp32 multiply by the scale."""
    m, k = x.shape
    part = _part_rows(k, slices)
    xl, wl = x.astype(np.int64), w.astype(np.int64)
    partials = []
    for i in range(slices):
        a, b = min(k, i * part), min(k, (i + 1) * part)
        dot = np.zeros((m, w.shape[1]), np.int64)
        for c0 in range(a, b, CHUNK):
            for k0 in range(c0, min(b, c0 + CHUNK), 32):
                xs = np.zeros((m, 32), np.int64)
                xs[:, :min(32, b - k0)] = xl[:, k0:min(b, k0 + 32)]
                ws = np.zeros((32, w.shape[1]), np.int64)
                ws[:min(32, k - k0)] = wl[k0:min(k, k0 + 32)]  # rows past b meet zeros
                dot += xs @ ws
        assert np.abs(dot).max() < 2**31
        partials.append(dot.astype(np.int32))
    total = np.zeros_like(partials[0])
    for i in order:
        total = total + partials[i]  # int32: exact, the whole dot is within int32
    return total.astype(np.float32) * s


@pytest.mark.parametrize("m,k,n,slices", [
    (3, 7, 8, 1),        # K 7: one short step
    (3, 7, 8, 16),       # K 7 over 16 slices: 15 empty
    (5, 100, 12, 2),     # slices of 64 and a short 36
    (5, 100, 12, 4),     # slices of 32, 32, 32 and 4
    (2, 100, 8, 16),     # slices of 32: four used, twelve empty
    (8, 4096, 16, 2),    # the (8, 4096, 11264) split
    (5, 1024, 16, 4),    # the (5, 1024, 4096) split
    (4, 16384, 16, 8),   # the (96, 16384, 2048) split
    (4, 16384, 16, 16),  # the largest S
])
def test_split_mirror_equals_reference(m, k, n, slices):
    """int32 partial dots per slice, added in a shuffled order and converted
    once: bit-equal to w8a8_matmul_reference (row-major and block-major),
    with scales that are not 1 and a column of dots past 2**24."""
    rng = np.random.RandomState(m * k + slices)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-128, 128, (k, n)).astype(np.int8)
    x[0] = 127
    w[:, 0] = 127  # x[0] . w[:, 0] = 127^2 K: past 2**24 at K >= 1041
    s = (rng.rand(1, n) * 1e-2 + 1e-4).astype(np.float32)
    order = rng.permutation(slices)
    got = _split_mirror(x, w, s, slices, order)
    xt, wt, st = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s)
    np.testing.assert_array_equal(got, t_w8a8.w8a8_matmul_reference(xt, wt, st).numpy())
    bm = lowbit.int8_block_major(wt, 4)
    np.testing.assert_array_equal(got, t_w8a8.w8a8_matmul_reference(xt, bm, st).numpy())
    if k >= 1041:
        assert 127 * 127 * k > 2**24
