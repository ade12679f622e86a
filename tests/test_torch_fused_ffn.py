"""K6, the fused GeGLU FFN kernel (``csrc/fused_ffn.cu``), mirrored on the CPU.

The kernel cannot run here, so what it does is written out and checked:
- the tile mirror: phase 1 block by block on ``grid``'s geometry (288 rows
  by 64 columns of I, the gate and up dots in fp32, the GeGLU in fp32, ``a``
  rounded to bf16), phase 2 per slice of K in fp32, the S
  partials of each 64-column tile added in slice order and rounded once;
  held against the Pallas kernel in interpret mode
  (``experiments/bench_fused_ffn.py:fused_ffn``) and against
  ``fused_ffn_reference``, within one bf16 step at the largest output;
- coverage: every element of ``a`` and of ``out`` is written by exactly one
  block (phase 2: by the block of the cluster that owns its rows), and every
  index of K falls in exactly one step of each phase;
- the shared-memory layouts: TMA's 128-byte swizzle of a box, and the
  ``wgmma`` descriptors (start, LBO, SBO, layout type) of the MN-major weight
  tile and the K-major activation tile, read through the PTX ISA's
  canonical layouts, put every (k, n) and (row, k) where TMA wrote it; the
  accumulator fragments cover a 64 x 144 tile once, and the epilogue's
  staging round-trips.

The kernel itself is held against the plain version on the card by the
``cuda`` tests of ``tests/test_torch_experiments.py`` and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from experiments import bench_fused_ffn
from blurr_tpu_torch.ops import fused_ffn as t_ffn
from blurr_tpu_torch.ops.activations import geglu

BF16_STEP = 2.0**-7  # neighbouring bf16 values lie at most 2^-7 of a value apart
ROWS, HALF, COLS, STEP = 288, 144, 64, 64  # the kernel's block and step
A_TILE, B_TILE = 64 * 64 * 2, 144 * 64 * 2  # bytes of a weight and an activation tile


def _operands(m, h, inter, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (m, h)).astype(np.float32)
    ws = [(rng.randn(*shape) * 0.02).astype(np.float32)
          for shape in ((h, inter), (h, inter), (inter, h))]
    return [torch.from_numpy(a).to(torch.bfloat16) for a in (x, *ws)]


def _rows(m, block):
    r0 = block * ROWS
    return r0, min(ROWS, m - r0)


def _slice_rows(rows, slices):
    """R, the rows each block of a phase 2 cluster owns (even)."""
    return 2 * -(-rows // (2 * slices))


def _k_slices(m, h, inter):
    """The rows of K = I each slice of phase 2 sums, in slice order, as
    (begin, end): ceil(I / 64 / S) steps of 64 each, the last short or
    empty (the kernel's slice_steps)."""
    s = t_ffn.grid(m, h, inter)[1][1]
    part = -(-(inter // STEP) // s) * STEP
    return [(min(i * part, inter), min((i + 1) * part, inter)) for i in range(s)]


def _mirror(x, wg, wu, wd):
    """The two phases as the kernel's blocks compute them."""
    m, h = x.shape
    inter = wg.shape[1]
    (row_blocks, i_tiles), (_, slices, h_tiles) = t_ffn.grid(m, h, inter)
    xf, wgf, wuf, wdf = (t.float() for t in (x, wg, wu, wd))
    a = torch.empty(m, inter, dtype=torch.bfloat16)
    for b in range(row_blocks):
        r0, n = _rows(m, b)
        for t in range(i_tiles):
            cols = slice(COLS * t, COLS * (t + 1))
            g, u = xf[r0:r0 + n] @ wgf[:, cols], xf[r0:r0 + n] @ wuf[:, cols]
            a[r0:r0 + n, cols] = geglu(g, u).to(torch.bfloat16)
    af = a.float()
    parts = _k_slices(m, h, inter)
    assert len(parts) == slices
    out = torch.empty(m, h, dtype=torch.bfloat16)
    for b in range(row_blocks):
        r0, n = _rows(m, b)
        for t in range(h_tiles):
            cols = slice(COLS * t, COLS * (t + 1))
            acc = None
            for k0, k1 in parts:  # slice order, fp32 adds
                part = af[r0:r0 + n, k0:k1] @ wdf[k0:k1, cols]
                acc = part if acc is None else acc + part
            out[r0:r0 + n, cols] = acc.to(torch.bfloat16)
    return a, out


# (M, H, I, block_i of the Pallas call): M 1, 17, 65 and 277 rows; I 64 (one
# column tile); H 1920 at a small I; I 1088 (17 steps of 64: four slices of
# 5, 5, 5 and 2 steps, a short last one)
MIRROR_SHAPES = [(1, 128, 256, 128), (17, 256, 1088, 64), (65, 128, 64, 64),
                 (277, 256, 512, 128), (40, 1920, 128, 128)]


@pytest.mark.parametrize("m,h,inter,block_i", MIRROR_SHAPES)
def test_tile_mirror_matches_pallas_and_reference(m, h, inter, block_i):
    """The mirror of the kernel's blocks against bench_fused_ffn.py:57
    fused_ffn (interpret) and fused_ffn_reference. Tolerance: one bf16 step
    at the largest output; the fp32 sums run in other orders (the Pallas
    call by blocks of I, the mirror by 64-column tiles and slices of K)."""
    x, wg, wu, wd = _operands(m, h, inter, seed=m + h + inter)
    a, got = _mirror(x, wg, wu, wd)
    ref = t_ffn.fused_ffn_reference(x, wg, wu, wd).float()
    with pltpu.force_tpu_interpret_mode():
        jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, wg, wu, wd)]
        pallas = np.array(bench_fused_ffn.fused_ffn(*jx, block_i=block_i).astype(jnp.float32))
    got = got.float()
    for want in (ref, torch.from_numpy(pallas)):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= BF16_STEP * want.abs().max().item()
    # a itself: each element the bf16 of the fp32 GeGLU, give or take one
    # rounding where the sums' order moves it across a bf16 boundary
    xf = x.float()
    a_ref = geglu(xf @ wg.float(), xf @ wu.float())
    assert (a.float() - a_ref).abs().max().item() <= BF16_STEP * a_ref.abs().max().item()


# (M, H, I): the harness shape, M 1, M 4096 (15 row blocks), two row blocks
# with a short last one, ragged ones
COVER_SHAPES = [(280, 2048, 16384), (1, 2048, 16384), (4096, 2048, 16384),
                (300, 1024, 2048), (17, 256, 1088), (65, 128, 64), (280, 1920, 1024),
                (145, 256, 320)]


@pytest.mark.parametrize("m,h,inter", COVER_SHAPES)
def test_every_element_written_once_and_every_k_summed_once(m, h, inter):
    (row_blocks, i_tiles), (rb2, slices, h_tiles) = t_ffn.grid(m, h, inter)
    assert rb2 == row_blocks and row_blocks * ROWS >= m > (row_blocks - 1) * ROWS
    assert i_tiles * COLS == inter and h_tiles * COLS == h
    a_writes = np.zeros((m, inter), np.int32)
    out_writes = np.zeros((m, h), np.int32)
    for b in range(row_blocks):
        r0, rows = _rows(m, b)
        # phase 1: warpgroup w stores its half's valid rows of the tile
        for t in range(i_tiles):
            for w in range(2):
                n = min(HALF, rows - HALF * w)
                if n > 0:
                    a_writes[r0 + HALF * w:r0 + HALF * w + n, COLS * t:COLS * (t + 1)] += 1
        # phase 2: block s of the cluster stores its own R rows of the tile
        R = _slice_rows(rows, slices)
        assert R % 2 == 0 and slices * R >= rows
        for t in range(h_tiles):
            for s in range(slices):
                own = max(0, min(R, rows - s * R))
                out_writes[r0 + s * R:r0 + s * R + own, COLS * t:COLS * (t + 1)] += 1
            # and every row a warpgroup sends lands in one owner's run
            for row in range(0, rows, 2):
                owner = row // R
                assert owner < slices and 0 <= row - owner * R < R
    assert (a_writes == 1).all() and (out_writes == 1).all()
    # K: phase 1 walks all of H in steps of 64; phase 2's slices tile I
    assert h % STEP == 0
    k_hits = np.zeros(inter, np.int32)
    parts = _k_slices(m, h, inter)
    for k0, k1 in parts:
        assert k0 % STEP == 0 and (k1 - k0) % STEP == 0
        k_hits[k0:k1] += 1
    assert (k_hits == 1).all()
    steps = [(k1 - k0) // STEP for k0, k1 in parts]
    assert steps == sorted(steps, reverse=True) and max(steps) == -(-(inter // STEP) // slices)


# ---------------------------------------------------- shared-memory layouts


def _tma_byte(r, e):
    """Where TMA's 128-byte swizzle puts element e (of 64) of box row r."""
    return r * 128 + 16 * (((e >> 3) ^ r) & 7) + 2 * (e & 7)


def _desc(addr, lbo, sbo):
    """The kernel's desc_sw128: start, LBO and SBO in bytes (>> 4), layout
    type 1 (128-byte swizzle) in bits 62-63."""
    return ((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16) \
        | (((sbo >> 4) & 0x3FFF) << 32) | (1 << 62)


def _decode(desc):
    assert desc >> 62 == 1  # 128-byte swizzle
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4)


def _swizzle128(addr):
    """The 128-byte swizzle on shared-memory address bits: the 16-byte chunk
    (bits 4-6) XOR the row of 128 bytes within 1024 (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _read_a_mn_major(desc, m, k):
    """The byte wgmma reads for A[m, k] (m < 64, k < 16), MN-major, 128-byte
    swizzle: ((8,8,m'),(8,k')):((1,8,LBO),(64,SBO)) in bf16 elements."""
    start, lbo, sbo = _decode(desc)
    return _swizzle128(start + 2 * (m % 64) + (m // 64) * lbo + 128 * (k % 8) + (k // 8) * sbo)


def _read_b_k_major(desc, n, k):
    """The byte wgmma reads for B[k, n] (n < N, k < 16), K-major, 128-byte
    swizzle: ((8,n'),(8,2)):((64,SBO),(1,8)) in bf16 elements."""
    start, _, sbo = _decode(desc)
    return _swizzle128(start + 128 * (n % 8) + (n // 8) * sbo + 2 * k)


@pytest.mark.parametrize("rows", [64, 144])
def test_tma_swizzle_is_a_bijection_of_the_box(rows):
    offsets = {_tma_byte(r, e) for r in range(rows) for e in range(64)}
    assert offsets == set(range(0, rows * 128, 2))


@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("matrix", [0, 1])
def test_weight_tile_descriptor_reads_what_tma_wrote(stage, matrix):
    """A[m, k] of the k16 step kk is weight element (row 16 kk + k, column
    m) of the tile: the descriptor (start + 2048 kk, LBO 8 KB, SBO 1024)
    reads it where TMA wrote it, for both weight tiles of any stage."""
    base = stage * (2 * A_TILE + 2 * B_TILE) + matrix * A_TILE
    assert base % 1024 == 0
    desc = _desc(base, A_TILE, 1024)
    for kk in range(4):
        d = desc + 128 * kk  # the kernel adds 2048 bytes to the start field
        reads = {(m, k): _read_a_mn_major(d, m, k) for m in range(64) for k in range(16)}
        for (m, k), byte in reads.items():
            assert byte == base + _tma_byte(16 * kk + k, m)
        assert len(set(reads.values())) == 64 * 16


@pytest.mark.parametrize("half", [0, 1])
def test_activation_tile_descriptor_reads_what_tma_wrote(half):
    """B[k, n] of the k16 step kk is activation row n, element 16 kk + k:
    the descriptor (start + 32 kk, SBO 1024) reads it where TMA wrote it,
    the start moved inside the 1024-byte swizzle atom."""
    base = 2 * A_TILE + half * B_TILE
    assert base % 1024 == 0
    desc = _desc(base, 16, 1024)
    for kk in range(4):
        d = desc + 2 * kk  # the kernel adds 32 bytes to the start field
        reads = {(n, k): _read_b_k_major(d, n, k) for n in range(HALF) for k in range(16)}
        for (n, k), byte in reads.items():
            assert byte == base + _tma_byte(n, 16 * kk + k)
        assert len(set(reads.values())) == HALF * 16


def _fragment(warp, lane, j):
    """D^T element j of a warpgroup thread of m64n144: (weight column,
    activation row)."""
    g, q = lane // 4, lane % 4
    return 16 * warp + g + 8 * ((j >> 1) & 1), 8 * (j >> 2) + 2 * q + (j & 1)


def test_accumulators_cover_the_tile_once():
    cells = [_fragment(w, lane, j) for w in range(4) for lane in range(32) for j in range(72)]
    assert sorted(cells) == [(c, r) for c in range(64) for r in range(HALF)]


def test_epilogue_staging_round_trips():
    """Phase 1 stores each a value at the swizzled (row, column) of its
    fragment, then reads 16-byte chunks: the chunks give each row's 64
    columns in order, so the global stores are row-major."""
    rng = np.random.RandomState(0)
    tile = rng.randn(HALF, 64).astype(np.float32)
    staged = np.full(HALF * 64, np.nan, np.float32)
    for w in range(4):
        for lane in range(32):
            for j in range(72):
                col, r = _fragment(w, lane, j)
                staged[_tma_byte(r, col) // 2] = tile[r, col]
    for r in range(HALF):
        row = np.concatenate([staged[_tma_byte(r, 8 * ch) // 2:][:8] for ch in range(8)])
        np.testing.assert_array_equal(row, tile[r])
