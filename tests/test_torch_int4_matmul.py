"""The port's int4 matmul (blurr_tpu_torch.ops.int4_matmul) against the JAX
package's blurr_tpu.ops.pallas_int4_matmul on the CPU.

The layout helpers must give JAX's bytes exactly. The plain version
``int4_matmul_reference`` is held against the Pallas kernel in interpret
mode, as tests/test_quant.py runs it, at 1e-6 of the sum of the group terms'
magnitudes: XLA on the CPU may fuse a group's multiply and add into one FMA
where the port rounds twice, so each of the G - 1 adds may land 1 ulp of its
operands apart (relative to the result, that is more where the terms
cancel). The CUDA kernel is held against the plain version bit for bit by the
``cuda`` tests below, which skip without a card (run them on the GPU with
``python -m pytest tests/test_torch_int4_matmul.py -m cuda``), and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.ops import pallas_int4_matmul as j_int4
from blurr_tpu_torch.ops import int4_matmul as t_int4

# the Pi-0 mixture widths (K and N of every linear at full width)
PI0_WIDTHS = (256, 1024, 2048, 4096, 16384)


def _int4(rng, k, n):
    return rng.randint(-8, 8, (k, n)).astype(np.int8)


def _packed(q: np.ndarray, bn: int) -> np.ndarray:
    return np.asarray(j_int4.to_block_major(j_int4.pack_int4(jnp.asarray(q)), bn))


@pytest.mark.parametrize("shape", [(10, 6), (2, 1), (64, 300), (3, 8, 40)])
def test_pack_unpack_match_jax_bytes(shape):
    q = np.random.RandomState(0).randint(-8, 8, shape).astype(np.int8)
    packed = t_int4.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(j_int4.pack_int4(jnp.asarray(q)))
    )
    np.testing.assert_array_equal(t_int4.unpack_int4_reference(packed).numpy(), q)
    np.testing.assert_array_equal(
        np.asarray(j_int4.unpack_int4_reference(jnp.asarray(packed.numpy()))), q
    )


def test_pack_rejects_odd_k():
    with pytest.raises(ValueError, match="even"):
        t_int4.pack_int4(torch.zeros(3, 4, dtype=torch.int8))


@pytest.mark.parametrize("lead,k2,n,bn", [((), 8, 256, 128), ((), 5, 1408, 1408),
                                           ((3,), 4, 512, 256)])
def test_block_major_both_ways_match_jax(lead, k2, n, bn):
    p = np.random.RandomState(1).randint(-128, 128, (*lead, k2, n)).astype(np.int8)
    bm = t_int4.to_block_major(torch.from_numpy(p), bn)
    assert bm.is_contiguous()
    np.testing.assert_array_equal(
        bm.numpy(), np.asarray(j_int4.to_block_major(jnp.asarray(p), bn))
    )
    np.testing.assert_array_equal(t_int4.from_block_major(bm).numpy(), p)
    np.testing.assert_array_equal(
        np.asarray(j_int4.from_block_major(jnp.asarray(bm.numpy()))), p
    )


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_layout_choices_match_jax(shards):
    """pick_block_layout over the Pi-0 widths and a seeded sweep, and
    pick_group_size over the same K values and preferred sizes."""
    sweep = np.random.RandomState(shards).randint(1, 40000, 200).tolist()
    for n in [*PI0_WIDTHS, 11008, 4304, 1152, 300, 48, *sweep]:
        assert t_int4.pick_block_layout(n, shards) == j_int4.pick_block_layout(n, shards), n
    for k in [*PI0_WIDTHS, 1152, 4304, 64, 96, 128, *sweep]:
        for preferred in (512, 256, 128, 1024):
            assert (t_int4.pick_group_size(k, preferred)
                    == j_int4.pick_group_size(k, preferred)), (k, preferred)


@pytest.mark.parametrize("m", [1, 4, 97])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_reference_matches_pallas_interpret(m, groups):
    """K 512, N 300 padded to 3 blocks of 128; scales of two magnitudes."""
    rng = np.random.RandomState(m * 10 + groups)
    k, n = 512, 300
    bn, n_pad = j_int4.pick_block_layout(n)
    q = _int4(rng, k, n_pad)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    s = (rng.rand(groups, n_pad) * 1e-2 + 1e-4).astype(np.float32)
    packed = _packed(q, bn)
    ref = np.asarray(j_int4.int4_matmul(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(s), interpret=True
    ))
    got = t_int4.int4_matmul_reference(
        torch.from_numpy(x), torch.from_numpy(np.array(packed)), torch.from_numpy(s)
    )
    assert got.dtype == torch.float32 and got.shape == (m, n_pad)
    rows = k // groups
    magnitude = sum(
        np.abs(x[:, g * rows:(g + 1) * rows].astype(np.int64)
               @ q[g * rows:(g + 1) * rows]) * s[g]
        for g in range(groups)
    )
    assert (np.abs(got.numpy() - ref) <= 1e-6 * magnitude).all()


def test_reference_is_the_group_sum_in_order():
    """Against numpy: exact int64 group dots, then fp32 multiply and add in
    group order; the port equals it bit for bit."""
    rng = np.random.RandomState(7)
    m, k, n, groups = 5, 256, 128, 4
    q = _int4(rng, k, n)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    s = rng.rand(groups, n).astype(np.float32)
    rows = k // groups
    want = None
    for g in range(groups):
        d = x[:, g * rows:(g + 1) * rows].astype(np.int64) @ q[g * rows:(g + 1) * rows]
        term = d.astype(np.float32) * s[g]
        want = term if want is None else want + term
    got = t_int4.int4_matmul(
        torch.from_numpy(x), torch.from_numpy(np.array(_packed(q, 128))),
        torch.from_numpy(s),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 64, dtype=torch.int8)
    packed = torch.zeros(1, 32, 128, dtype=torch.int8)
    s = torch.ones(1, 128)
    with pytest.raises(ValueError, match="int8"):
        t_int4.int4_matmul(x.float(), packed, s)
    with pytest.raises(ValueError, match="float32"):
        t_int4.int4_matmul(x, packed, s.double())
    with pytest.raises(ValueError, match="shapes"):
        t_int4.int4_matmul(torch.zeros(2, 62, dtype=torch.int8), packed, s)
    with pytest.raises(ValueError, match="shapes"):
        t_int4.int4_matmul(x, packed, torch.ones(3, 128))  # 3 does not divide 64
    with pytest.raises(ValueError, match="contiguous"):
        t_int4.int4_matmul(torch.zeros(64, 2, dtype=torch.int8).t(), packed, s)
    with pytest.raises(ValueError, match="takes"):
        t_int4.int4_matmul(x[None], packed, s)


def test_cpu_path_does_not_count_launches():
    before = t_int4.int4_matmul.launches
    t_int4.int4_matmul(
        torch.zeros(2, 64, dtype=torch.int8),
        torch.zeros(1, 32, 128, dtype=torch.int8), torch.ones(1, 128),
    )
    assert t_int4.int4_matmul.launches == before


def _sext_nibbles(v: np.ndarray) -> np.ndarray:
    """The kernel's sext_nibbles on uint32 words: each byte's low nibble as
    the signed byte it encodes, ((v ^ 8) + 0x78) ^ 0x80 on whole words."""
    return ((v ^ np.uint32(0x08080808)) + np.uint32(0x78787878)) ^ np.uint32(0x80808080)


def _byte_perm(x: np.ndarray, y: np.ndarray, selector: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (selector >> 4 i) & 7
    of the eight bytes of (y, x), x's the low four."""
    pool = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(4):
        b = (selector >> (4 * i)) & 7
        out |= (((pool >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint32)
                << np.uint32(8 * i))
    return out


def _unpack_word(r: np.ndarray):
    """The kernel's unpack(): the word ldmatrix.trans hands a lane, bytes
    (packed row 2t, column c), (2t, c + 1), (2t + 1, c), (2t + 1, c + 1), to
    the B fragments of column c and c + 1 (K rows 4t .. 4t + 3, byte 0 the
    lowest)."""
    lo = _sext_nibbles(r & np.uint32(0x0F0F0F0F))
    hi = _sext_nibbles((r >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
    return _byte_perm(lo, hi, 0x6240), _byte_perm(lo, hi, 0x7351)


def test_in_register_unpack_equals_the_reference_for_every_byte_pair():
    """All 65,536 pairs of the two packed bytes of one column (packed rows
    2t and 2t + 1), in the even column of one word and the odd column of
    another, unpacked as the kernel does, against unpack_int4_reference."""
    pairs = np.arange(1 << 16, dtype=np.uint32)
    b0, b1 = pairs & 0xFF, pairs >> 8  # packed rows 2t, 2t + 1
    # bytes (2t, c), (2t, c + 1), (2t + 1, c), (2t + 1, c + 1): the pair in
    # column c, and reversed in column c + 1
    word = b0 | (b1 << 8) | (b1 << 16) | (b0 << 24)
    even, odd = _unpack_word(word)
    packed = np.stack([np.stack([b0, b1], -1), np.stack([b1, b0], -1)], -2)  # [.., 2, 2]
    want = t_int4.unpack_int4_reference(
        torch.from_numpy(packed.astype(np.uint8).view(np.int8))).numpy()  # [.., 4, 2]
    for got, col in ((even, 0), (odd, 1)):
        got_bytes = got.view(np.uint8).reshape(-1, 4).view(np.int8)  # little-endian
        np.testing.assert_array_equal(got_bytes, want[:, :, col])


def _split_mirror(x, packed, scale, slices):
    """The kernel's split in plain torch: S slices of whole groups (S
    divides G) or of parts of one group (S = G P, parts of ceil(K/G / P)
    rows rounded up to 32, the last short or empty), each walked in chunks
    of 256 rows and steps of 32 with x zero past the slice's rows, giving
    exact integer partial dots (held to int32) per group; the parts summed,
    then each group's dot converted, scaled and added in group order."""
    m, k = x.shape
    groups = scale.shape[0]
    group_rows = k // groups
    w = t_int4.unpack_int4_reference(t_int4.from_block_major(packed)).to(torch.int64)
    xl = x.to(torch.int64)
    if groups % slices == 0:
        gps = groups // slices
        segments = [(g, g * group_rows, (g + 1) * group_rows)
                    for s in range(slices) for g in range(s * gps, (s + 1) * gps)]
    else:
        assert slices % groups == 0
        parts = slices // groups
        part_rows = (group_rows + parts - 1) // parts
        part_rows = (part_rows + 31) // 32 * 32
        segments = []
        for s in range(slices):
            g, p = divmod(s, parts)
            a = g * group_rows + min(group_rows, p * part_rows)
            segments.append((g, a, g * group_rows + min(group_rows, (p + 1) * part_rows)))
    dots = [torch.zeros(m, w.shape[1], dtype=torch.int64) for _ in range(groups)]
    for g, a, b in segments:
        part = torch.zeros_like(dots[0])
        for c0 in range(a, b, 256):
            for k0 in range(c0, min(b, c0 + 256), 32):
                xs = torch.zeros(m, 32, dtype=torch.int64)
                xs[:, : min(32, b - k0)] = xl[:, k0:min(b, k0 + 32)]
                ws = torch.zeros(32, w.shape[1], dtype=torch.int64)
                ws[: min(32, k - k0)] = w[k0:min(k, k0 + 32)]  # rows past b meet zeros
                part += xs @ ws
                assert part.abs().max() < 2**31
        dots[g] += part
    acc = None
    for g in range(groups):
        assert dots[g].abs().max() < 2**31
        term = dots[g].to(torch.float32) * scale[g]
        acc = term if acc is None else acc + term
    return acc


@pytest.mark.parametrize("m,k,n,groups,slices", [
    (5, 256, 128, 1, 4),    # parts of one group, 64 rows each
    (5, 512, 256, 8, 2),    # whole groups, 4 a slice
    (3, 512, 128, 4, 16),   # parts of 32 rows (4 per group)
    (3, 200, 128, 2, 4),    # K/G 100: parts of 64 and a short 36
    (4, 96, 128, 1, 4),     # parts of 32: the last one empty
    (6, 96, 128, 2, 1),     # K/G 48, one slice: a 32-row step half zeros
    (2, 1100, 128, 2, 2),   # K/G 550: whole groups over chunks of 256
])
def test_split_mirror_equals_reference(m, k, n, groups, slices):
    """int32 partial dots per slice, summed, then the group epilogue in
    order: bit-equal to int4_matmul_reference for splits inside a group,
    across groups, and with short or empty last slices."""
    rng = np.random.RandomState(m * k + slices)
    q = _int4(rng, k, n)
    x = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    s = torch.from_numpy((rng.rand(groups, n) * 1e-2 + 1e-4).astype(np.float32))
    packed = t_int4.to_block_major(t_int4.pack_int4(torch.from_numpy(q)), 128)
    assert torch.equal(_split_mirror(x, packed, s, slices),
                       t_int4.int4_matmul_reference(x, packed, s))


def test_wrapper_takes_blocks_of_16_columns_only():
    """The kernel loads 16-byte vectors of the packed weight: BN must be a
    multiple of 16 (every block width pick_block_layout gives is)."""
    with pytest.raises(ValueError, match="multiple of 16"):
        t_int4.int4_matmul(torch.zeros(2, 64, dtype=torch.int8),
                           torch.zeros(2, 32, 8, dtype=torch.int8), torch.ones(1, 16))
    assert all(bn % 16 == 0 for bn in t_int4._BLOCK_WIDTHS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (M, K, N, G) of every w4a8 linear of the Pi-0 control step, and ragged ones
CUDA_SHAPES = [
    (96, 2048, 2048, 4), (96, 2048, 256, 4), (96, 2048, 16384, 4),
    (96, 16384, 2048, 32), (1, 1024, 2048, 2), (4, 1024, 256, 2),
    (4, 2048, 1024, 4), (4, 1024, 4096, 2), (4, 4096, 1024, 8),
    (97, 512, 300, 4), (3, 64, 300, 1),
    # the experiments' K2 at one group (BN 1408); K/G 48 (a half-zero step of
    # 32 rows); K/G 50 (x staged byte by byte)
    (8, 4096, 11264, 1), (5, 96, 256, 2), (7, 100, 256, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,groups", CUDA_SHAPES)
def test_kernel_equals_plain_on_cuda(cuda_device, m, k, n, groups):
    rng = np.random.RandomState(m + k + n)
    bn, n_pad = t_int4.pick_block_layout(n)
    q = _int4(rng, k, n_pad)
    x = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8)).to(cuda_device)
    s = torch.from_numpy(rng.rand(groups, n_pad).astype(np.float32)).to(cuda_device)
    packed = t_int4.to_block_major(
        t_int4.pack_int4(torch.from_numpy(q)), bn).to(cuda_device)
    before = t_int4.int4_matmul.launches
    out = t_int4.int4_matmul(x, packed, s)
    torch.cuda.synchronize()
    assert t_int4.int4_matmul.launches == before + 1
    assert torch.equal(out, t_int4.int4_matmul_reference(x, packed, s))
    assert torch.equal(out, t_int4.int4_matmul(x, packed, s))  # the same bits again


@pytest.mark.cuda
def test_kernel_grid_at_the_step_shapes(cuda_device):
    """The split of K the source's header names: enough blocks to fill the
    card, at most 16 slices; no split where the column tiles fill it."""
    assert t_int4.grid(96, 2048, 2048, 4) == (16, 16, 1)
    assert t_int4.grid(96, 16384, 2048, 32) == (16, 16, 1)
    assert t_int4.grid(4, 1024, 4224, 2) == (66, 4, 1)
    assert t_int4.grid(4, 4096, 1024, 8) == (16, 16, 1)
    assert t_int4.grid(96, 2048, 16896, 4) == (132, 1, 1)
    assert t_int4.slices(8, 4096, 11264, 1) == 2
