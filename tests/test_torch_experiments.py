"""The port's counterparts of the experiment kernels against the 14 Pallas
calls of ``experiments/`` on the CPU.

Each Pallas call runs under ``pltpu.force_tpu_interpret_mode()`` at its
harness's own fixed shapes (the harness functions read their module's M, K,
NP), with numpy-seeded int8 and int4 inputs, and is held against the port's
wrapper on CPU tensors, which runs the kernel's plain version:
- the w8a8 product (``pallas_int8``, ``make_int8``, ``pallas_int8_bm``) against
  ``ops/w8a8_matmul.w8a8_matmul`` (K4);
- the split-half int4 product (``pallas_w4``, ``make_w4``, ``run_shift2``,
  ``run_biased``) against ``ops/int4_split_matmul.int4_split_matmul`` (K5);
- the bitcast int4 product (``run_bitcast``, the ``make`` of tune3 to tune6,
  ``dbuf_w4``) against ``experiments/lowbit.int4_adjacent_matmul``: K2 at one
  group over the whole of K;
- the fused GeGLU FFN (``fused_ffn``) against ``ops/fused_ffn.fused_ffn``
  (K6).
The integer products are equal exactly: every dot is an exact integer and
the scales are 1, as in the harnesses. K6 is held within one bf16 step at the
largest output (see ``test_fused_ffn_matches_pallas_and_xla``).

The CUDA kernels are held against the same plain versions by the ``cuda``
tests at the end, which skip without a card (run them on the GPU with
``python -m pytest tests/test_torch_experiments.py -m cuda``), and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from experiments import (
    bench_fused_ffn,
    bench_pallas_int4,
    bench_pallas_int4_dbuf,
    bench_pallas_int4_tune,
    bench_pallas_int4_tune2,
    bench_pallas_int4_tune3,
    bench_pallas_int4_tune4,
    bench_pallas_int4_tune5,
    bench_pallas_int4_tune6,
    bench_pallas_int8_blockmajor,
)
from blurr_tpu_torch.experiments import bench_fused_ffn as t_bench_ffn
from blurr_tpu_torch.experiments import bench_lowbit_matmul as t_bench_lowbit
from blurr_tpu_torch.experiments import lowbit, timing
from blurr_tpu_torch.ops import fused_ffn as t_ffn
from blurr_tpu_torch.ops import int4_split_matmul as t_split
from blurr_tpu_torch.ops import w8a8_matmul as t_w8a8
from blurr_tpu_torch.ops.int4_matmul import int4_matmul, pack_int4, to_block_major

# bf16 has 8 significant bits: neighbouring values lie at most 2^-7 of a
# value apart, so two roundings of nearly equal sums differ by one such step
BF16_STEP = 2.0**-7
K, NP = 4096, 11264  # the harnesses' K and padded N


def _x(m, k, seed):
    return np.random.RandomState(seed).randint(-127, 128, (m, k)).astype(np.int8)


def _int4(k, n, seed):
    return np.random.RandomState(seed).randint(-8, 8, (k, n)).astype(np.int8)


def _ones(n):
    return np.ones((1, n), np.float32)


def _pallas(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def _port(fn, *args, **kwargs):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kwargs).numpy()


# ---------------------------------------------------------------- layouts


def _jnp_split_half(q):  # bench_pallas_int4.py:87 (and _tune.py:94, _tune2.py:127)
    k = q.shape[-2]
    return ((q[..., : k // 2, :] & 0x0F) | ((q[..., k // 2 :, :] & 0x0F) << 4)).astype(jnp.int8)


@pytest.mark.parametrize("shape", [(8, 12), (2, 6, 40), (4096, 16)])
def test_split_half_packings_give_the_harness_bytes(shape):
    q = np.random.RandomState(len(shape)).randint(-8, 8, shape).astype(np.int8)
    qj = jnp.asarray(q)
    np.testing.assert_array_equal(
        lowbit.pack_split_half(torch.from_numpy(q)).numpy(), np.asarray(_jnp_split_half(qj)))
    # bench_pallas_int4_tune2.py:129-130: nibbles q + 8
    biased = _jnp_split_half((qj + 8).astype(jnp.int8))
    np.testing.assert_array_equal(
        lowbit.pack_split_half_biased(torch.from_numpy(q)).numpy(), np.asarray(biased))
    for packed, flag in ((lowbit.pack_split_half, False), (lowbit.pack_split_half_biased, True)):
        back = t_split.unpack_split_half_reference(packed(torch.from_numpy(q)), biased=flag)
        np.testing.assert_array_equal(back.numpy(), q)


def test_adjacent_packing_gives_the_bitcast_harness_bytes():
    """bench_pallas_int4_tune2.py:132 (pk_adj, the nibble order of
    pltpu.bitcast to int4) is K2's pack_int4; tune6's block-major stack
    (:86) is K2's to_block_major."""
    q = _int4(64, 2816, 2)
    qj = jnp.asarray(q)
    pk_adj = ((qj[0::2, :] & 0x0F) | ((qj[1::2, :] & 0x0F) << 4)).astype(jnp.int8)
    packed = pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(pk_adj))
    bn = lowbit.adjacent_block_width(2816)
    pk_bm = jnp.stack([pk_adj[:, i * bn:(i + 1) * bn] for i in range(2816 // bn)], axis=0)
    np.testing.assert_array_equal(to_block_major(packed, bn).numpy(), np.asarray(pk_bm))


@pytest.mark.parametrize("k,n,bn", [(16, 2048, 1024), (7, 4096, 2048)])
def test_int8_block_major_gives_the_harness_bytes(k, n, bn):
    w = np.random.RandomState(3).randint(-127, 128, (2, k, n)).astype(np.int8)
    # bench_pallas_int8_blockmajor.py:99
    want = jnp.moveaxis(jnp.asarray(w).reshape(2, k, n // bn, bn), 2, 1)
    np.testing.assert_array_equal(
        lowbit.int8_block_major(torch.from_numpy(w), bn).numpy(), np.asarray(want))


def test_adjacent_block_width_takes_no_padding():
    assert lowbit.adjacent_block_width(NP) == 1408
    with pytest.raises(ValueError, match="padding"):
        lowbit.adjacent_block_width(300)


# ------------------------------------------------------ K4: w8a8 product


def test_pallas_int8_equals_k4():
    """bench_pallas_int4.py:52 pallas_int8 at (8, 4096, 11264)."""
    x, w = _x(8, K, 10), np.random.RandomState(11).randint(-127, 128, (K, NP)).astype(np.int8)
    want = _pallas(bench_pallas_int4.pallas_int8, x, w, _ones(NP))
    np.testing.assert_array_equal(_port(t_w8a8.w8a8_matmul, x, w, _ones(NP)), want)


@pytest.mark.parametrize("m,bn", [(8, 1024), (32, 2816)])
def test_tune_make_int8_equals_k4(m, bn):
    """bench_pallas_int4_tune.py:46 make_int8 at its m and block_n."""
    x, w = _x(m, K, m), np.random.RandomState(12).randint(-127, 128, (K, NP)).astype(np.int8)
    want = _pallas(bench_pallas_int4_tune.make_int8(m, bn), x, w, _ones(NP))
    np.testing.assert_array_equal(_port(t_w8a8.w8a8_matmul, x, w, _ones(NP)), want)


@pytest.mark.parametrize("m,k,n", [(5, 1024, 4096), (13, 256, 2048)])
def test_pallas_int8_block_major_equals_k4(m, k, n):
    """bench_pallas_int8_blockmajor.py:49 pallas_int8_bm (its decode shape
    and a small one; block_n as the harness picks it), with scales that are
    not 1 so the fp32 rounding of the int32 dot and the multiply show."""
    bn = 2048 if n % 2048 == 0 else 1024
    x = _x(m, k, 13)
    w = np.random.RandomState(14).randint(-127, 128, (k, n)).astype(np.int8)
    s = (np.random.RandomState(15).rand(1, n) * 1e-2 + 1e-4).astype(np.float32)
    w_bm = lowbit.int8_block_major(torch.from_numpy(w), bn).numpy()
    want = _pallas(bench_pallas_int8_blockmajor.pallas_int8_bm(m, k, n, bn), x, w_bm, s)
    np.testing.assert_array_equal(_port(t_w8a8.w8a8_matmul, x, w_bm, s), want)
    np.testing.assert_array_equal(_port(t_w8a8.w8a8_matmul, x, w, s), want)


def test_w8a8_reference_rounds_the_int32_dot_once():
    """Against numpy: the exact int64 dot, one rounding to fp32, one fp32
    multiply; dots past 2**24 show the rounding."""
    rng = np.random.RandomState(16)
    x = np.full((3, 2048), 127, np.int8)
    x[1] = rng.randint(-128, 128, 2048)
    w = rng.randint(-128, 128, (2048, 8)).astype(np.int8)
    w[:, 0] = 127
    s = rng.rand(1, 8).astype(np.float32)
    want = (x.astype(np.int64) @ w).astype(np.float32) * s
    assert abs(int(x[0].astype(np.int64) @ w[:, 0])) > 2**24
    np.testing.assert_array_equal(_port(t_w8a8.w8a8_matmul, x, w, s), want)


def test_w8a8_wrapper_rejects_what_the_kernel_does_not_take():
    x, w, s = torch.zeros(2, 64, dtype=torch.int8), torch.zeros(64, 8, dtype=torch.int8), torch.ones(1, 8)
    with pytest.raises(ValueError, match="int8"):
        t_w8a8.w8a8_matmul(x.float(), w, s)
    with pytest.raises(ValueError, match="float32"):
        t_w8a8.w8a8_matmul(x, w, s.double())
    with pytest.raises(ValueError, match="takes"):
        t_w8a8.w8a8_matmul(x, w, torch.ones(8))
    with pytest.raises(ValueError, match="shapes"):
        t_w8a8.w8a8_matmul(x, w, torch.ones(1, 12))
    with pytest.raises(ValueError, match="shapes"):
        t_w8a8.w8a8_matmul(x, torch.zeros(2, 64, 3, dtype=torch.int8), torch.ones(1, 6))
    with pytest.raises(ValueError, match="contiguous"):
        t_w8a8.w8a8_matmul(x, torch.zeros(8, 64, dtype=torch.int8).t(), s)


# --------------------------------------------- K5: split-half int4 product


def test_pallas_w4_equals_k5():
    """bench_pallas_int4.py:67 pallas_w4 at (8, 4096, 11264)."""
    x, q = _x(8, K, 20), _int4(K, NP, 21)
    packed = lowbit.pack_split_half(torch.from_numpy(q)).numpy()
    want = _pallas(bench_pallas_int4.pallas_w4, x, packed, _ones(NP))
    np.testing.assert_array_equal(want, (x.astype(np.int64) @ q).astype(np.float32))
    np.testing.assert_array_equal(_port(t_split.int4_split_matmul, x, packed, _ones(NP)), want)


@pytest.mark.parametrize("m,native", [(8, False), (8, True), (32, True)])
def test_tune_make_w4_equals_k5(m, native):
    """bench_pallas_int4_tune.py:65 make_w4 (block_n 1024), both unpackings."""
    x, q = _x(m, K, 22 + m), _int4(K, NP, 23)
    packed = lowbit.pack_split_half(torch.from_numpy(q)).numpy()
    want = _pallas(bench_pallas_int4_tune.make_w4(m, 1024, native), x, packed, _ones(NP))
    np.testing.assert_array_equal(_port(t_split.int4_split_matmul, x, packed, _ones(NP)), want)


@pytest.mark.parametrize("biased", [False, True])
def test_tune2_shift2_and_biased_equal_k5(biased):
    """bench_pallas_int4_tune2.py:62 run_shift2 and :94 run_biased."""
    x, q = _x(8, K, 24), _int4(K, NP, 25)
    pack = lowbit.pack_split_half_biased if biased else lowbit.pack_split_half
    packed = pack(torch.from_numpy(q)).numpy()
    run = bench_pallas_int4_tune2.run_biased if biased else bench_pallas_int4_tune2.run_shift2
    want = _pallas(run, x, packed, _ones(NP))
    got = _port(t_split.int4_split_matmul, x, packed, _ones(NP), biased=biased)
    np.testing.assert_array_equal(got, want)


def test_split_wrapper_rejects_what_the_kernel_does_not_take():
    x, p, s = torch.zeros(2, 64, dtype=torch.int8), torch.zeros(32, 8, dtype=torch.int8), torch.ones(1, 8)
    with pytest.raises(ValueError, match="int8"):
        t_split.int4_split_matmul(x.float(), p, s)
    with pytest.raises(ValueError, match="shapes"):
        t_split.int4_split_matmul(x, torch.zeros(31, 8, dtype=torch.int8), s)
    with pytest.raises(ValueError, match="shapes"):
        t_split.int4_split_matmul(x, torch.zeros(32, 6, dtype=torch.int8), torch.ones(1, 6))
    with pytest.raises(ValueError, match="contiguous"):
        t_split.int4_split_matmul(x, torch.zeros(8, 32, dtype=torch.int8).t(), s)


# ------------------------------ K2 at one group: the bitcast int4 product


def _adjacent(m, seed):
    x, q = _x(m, K, seed), _int4(K, NP, seed + 1)
    return x, q, pack_int4(torch.from_numpy(q)).numpy()


def test_tune2_bitcast_equals_k2_one_group():
    """bench_pallas_int4_tune2.py:77 run_bitcast: pltpu.bitcast's nibble
    order is the adjacent-row one, low nibble the even row."""
    x, q, packed = _adjacent(8, 30)
    want = _pallas(bench_pallas_int4_tune2.run_bitcast, x, packed, _ones(NP))
    np.testing.assert_array_equal(want, (x.astype(np.int64) @ q).astype(np.float32))
    np.testing.assert_array_equal(_port(lowbit.int4_adjacent_matmul, x, packed, _ones(NP)), want)


@pytest.mark.parametrize("bn,direct", [(1024, False), (1024, True)])
def test_tune3_equals_k2_one_group(bn, direct):
    """bench_pallas_int4_tune3.py:36 (make), the int4 operand widened or
    fed to the dot as it is. Its other block width, 2048, does not divide
    NP: that grid leaves the last 1024 columns unwritten."""
    x, _, packed = _adjacent(8, 32)
    want = _pallas(bench_pallas_int4_tune3.make(bn, direct), x, packed, _ones(NP))
    np.testing.assert_array_equal(_port(lowbit.int4_adjacent_matmul, x, packed, _ones(NP)), want)


@pytest.mark.parametrize("module,bn", [(bench_pallas_int4_tune4, 1408),
                                       (bench_pallas_int4_tune5, 704)])
def test_tune4_tune5_equal_k2_one_group(module, bn):
    """bench_pallas_int4_tune4.py:42 and _tune5.py:42 (make, with the cost
    estimate and VMEM limit they sweep)."""
    x, _, packed = _adjacent(8, 34)
    want = _pallas(module.make(bn, 64, True), x, packed, _ones(NP))
    np.testing.assert_array_equal(_port(lowbit.int4_adjacent_matmul, x, packed, _ones(NP)), want)


@pytest.mark.parametrize("m,layout", [(8, "row"), (8, "block"), (96, "block")])
def test_tune6_equals_k2_one_group(m, layout):
    """bench_pallas_int4_tune6.py:54 (make) on the row-major and the
    block-major weight; K2 takes the block-major one as it is."""
    x, _, packed = _adjacent(m, 36)
    bn = bench_pallas_int4_tune6.BN
    weights = packed if layout == "row" else to_block_major(torch.from_numpy(packed), bn).numpy()
    want = _pallas(bench_pallas_int4_tune6.make(m, layout), x, weights, _ones(NP))
    got = (_port(lowbit.int4_adjacent_matmul, x, packed, _ones(NP)) if layout == "row"
           else _port(int4_matmul, x, weights, _ones(NP)))
    np.testing.assert_array_equal(got, want)


def test_dbuf_equals_k2_one_group():
    """bench_pallas_int4_dbuf.py:64 dbuf_w4, its manual double-buffered DMA
    run by the interpreter (block-major weight, as its harness lays it)."""
    x, _, packed = _adjacent(8, 38)
    bn = bench_pallas_int4_dbuf.BN
    bm = to_block_major(torch.from_numpy(packed), bn).numpy()
    want = _pallas(bench_pallas_int4_dbuf.dbuf_w4, x, bm, _ones(NP))
    np.testing.assert_array_equal(_port(int4_matmul, x, bm, _ones(NP)), want)


# ------------------------------------------------ K6: fused GeGLU FFN


def _ffn_operands(m, h, inter, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (m, h)).astype(np.float32)
    ws = [(rng.randn(*shape) * 0.02).astype(np.float32)
          for shape in ((h, inter), (h, inter), (inter, h))]
    return [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, *ws)]


def _to_torch_bf16(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("m,h,inter,block_i", [(16, 128, 256, 128), (20, 256, 512, 256)])
def test_fused_ffn_matches_pallas_and_xla(m, h, inter, block_i):
    """bench_fused_ffn.py:57 fused_ffn (interpret) and the harness's own
    xla_ffn against the port's fused_ffn on CPU tensors. Tolerance: one bf16
    step at the largest output (2^-7 * max|out|). Against fused_ffn the
    numerics are the same (fp32 dots, a rounded to bf16, fp32 down product)
    and only the fp32 summation order differs, which may move an a or an
    output to the neighbouring bf16 (it read 0 here). xla_ffn rounds g, u
    and gelu(g) * u to bf16 as well (bf16 dots and ops); it sits one step
    from both at the largest output at these widths."""
    x, wg, wu, wd = _ffn_operands(m, h, inter, seed=m + h)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(bench_fused_ffn.fused_ffn(x, wg, wu, wd, block_i=block_i)
                            .astype(jnp.float32))
    xla = np.asarray(bench_fused_ffn.xla_ffn(x, wg, wu, wd).astype(jnp.float32))
    got = t_ffn.fused_ffn(*map(_to_torch_bf16, (x, wg, wu, wd)))
    assert got.dtype == torch.bfloat16 and got.shape == (m, h)
    got = got.float().numpy()
    for want in (pallas, xla):
        bound = BF16_STEP * np.abs(want).max()
        assert np.abs(got - want).max() <= bound


def test_fused_ffn_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    wg = torch.zeros(128, 64, dtype=torch.bfloat16)
    wd = torch.zeros(64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        t_ffn.fused_ffn(x.float(), wg, wg, wd)
    with pytest.raises(ValueError, match="shapes"):
        t_ffn.fused_ffn(x, wg, wg, wg)
    with pytest.raises(ValueError, match="multiple of 128"):
        t_ffn.fused_ffn(x[:, :96], wg[:96], wg[:96], wd[:, :96].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        t_ffn.fused_ffn(x, wg, wg, wg.t())


# (M, H, I): ((row blocks, I tiles), (row blocks, S, H tiles)) of K6
FFN_GRIDS = [((280, 2048, 16384), ((1, 256), (1, 3, 32))),  # the harness
             ((1, 2048, 16384), ((1, 256), (1, 3, 32))),
             ((4096, 2048, 16384), ((15, 256), (15, 1, 32))),  # 480 tiles: no split
             ((300, 1024, 2048), ((2, 32), (2, 3, 16))),
             ((280, 1920, 1024), ((1, 16), (1, 4, 30)))]


@pytest.mark.parametrize("shape,want", FFN_GRIDS)
def test_grid_fills_the_card(shape, want):
    """K6's geometry: blocks of 288 rows by 64 weight columns; the down
    phase splits K into the S slices whose clusters all fit on the card at
    once (at most 39 clusters of 3, 30 of 4, 15 of 8 on an H100 SXM), each
    slice at least 4 steps of 64."""
    m, h, inter = shape
    got = t_ffn.grid(m, h, inter)
    assert got == want
    (rows, i_tiles), (rows2, s, h_tiles) = got
    tiles = rows2 * h_tiles
    assert rows == rows2 and i_tiles * 64 == inter and h_tiles * 64 == h
    assert tiles <= t_ffn._CLUSTERS[s] or s == 1
    assert inter // 64 >= 4 * s or s == 1


# ----------------------------------------------- counts and the card


def test_cpu_paths_do_not_count_launches():
    fns = (t_w8a8.w8a8_matmul, t_split.int4_split_matmul, t_ffn.fused_ffn)
    before = [f.launches for f in fns]
    t_w8a8.w8a8_matmul(torch.zeros(2, 64, dtype=torch.int8), torch.zeros(64, 8, dtype=torch.int8),
                       torch.ones(1, 8))
    t_split.int4_split_matmul(torch.zeros(2, 64, dtype=torch.int8),
                              torch.zeros(32, 8, dtype=torch.int8), torch.ones(1, 8))
    t_ffn.fused_ffn(torch.zeros(2, 128, dtype=torch.bfloat16),
                    torch.zeros(128, 64, dtype=torch.bfloat16),
                    torch.zeros(128, 64, dtype=torch.bfloat16),
                    torch.zeros(64, 128, dtype=torch.bfloat16))
    assert [f.launches for f in fns] == before


# ---------------------------------------------- the entry points


@pytest.mark.parametrize("bench", [t_bench_lowbit, t_bench_ffn])
def test_entry_points_run_the_plain_versions_on_the_cpu(bench, capsys):
    """Each entry point at CPU size: every function checked, no time
    printed (the CPU runs the plain versions)."""
    assert bench.main(["--device", "cpu", "--small"]) == 0
    out = capsys.readouterr().out
    assert "card: cpu, plain versions, no times" in out and " ms (CUDA" not in out
    if bench is t_bench_lowbit:
        assert out.count("bit-equal to its plain version") == 13
    else:
        assert "max_abs_err 0.000e+00" in out


@pytest.mark.parametrize("bench", [t_bench_lowbit, t_bench_ffn])
def test_entry_points_want_the_card_by_default(bench, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    assert bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bound_is_the_larger_of_bytes_and_operations():
    x, w = torch.zeros(8, 4096, dtype=torch.int8), torch.zeros(4096, 11264, dtype=torch.int8)
    out = torch.zeros(8, 11264)
    b = timing.bound((x, w), (out,), 2 * 8 * 4096 * 11264, "int8")
    n_bytes = 8 * 4096 + 4096 * 11264 + 8 * 11264 * 4
    assert b == {"bound_ms": n_bytes / 3.35e12 * 1e3, "bound_by": "bytes"}
    b = timing.bound((x[:1, :1],), (), 2e12, "bf16")
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(2e12 / 989e12 * 1e3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _int8_on(device, shape, seed, low=-127, high=128):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(low, high, shape, dtype=torch.int8, device=device, generator=g)


def _scales(device, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(1, n, device=device, generator=g) * 1e-2 + 1e-4


# (M, K, N, BN) of the w8a8 harnesses (BN None: row-major), and ragged ones;
# then the edges of the tiles (M 1, 16, 17, 95, 97, 145), K 16384 at the largest
# split (S 16), BN 1024 at N 4096, N 260 row-major (4-byte weight copies)
W8A8_CUDA_SHAPES = [(8, 4096, 11264, None), (32, 4096, 11264, None),
                    (96, 2048, 16384, 2048), (96, 16384, 2048, 2048),
                    (276, 2048, 16384, 2048), (5, 1024, 4096, 1024), (3, 100, 260, None),
                    (17, 7, 8, 4),
                    (1, 4096, 11264, None), (16, 1024, 4096, 1024), (17, 2048, 2048, None),
                    (95, 2048, 4096, 2048), (97, 1000, 260, None), (4, 16384, 256, None),
                    (33, 256, 260, None), (145, 256, 384, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,bn", W8A8_CUDA_SHAPES)
def test_w8a8_kernel_equals_plain_on_cuda(cuda_device, m, k, n, bn):
    x, w = _int8_on(cuda_device, (m, k), m), _int8_on(cuda_device, (k, n), k)
    if bn is not None:
        w = lowbit.int8_block_major(w, bn)
    s = _scales(cuda_device, n, n)
    before = t_w8a8.w8a8_matmul.launches
    out = t_w8a8.w8a8_matmul(x, w, s)
    torch.cuda.synchronize()
    assert t_w8a8.w8a8_matmul.launches == before + 1
    assert torch.equal(out, t_w8a8.w8a8_matmul_reference(x, w, s))
    assert torch.equal(out, t_w8a8.w8a8_matmul(x, w, s))  # the same bits again


@pytest.mark.cuda
def test_w8a8_kernel_grid_fills_the_card_at_the_harness_shapes(cuda_device):
    """The split of K the source's header names: where the column tiles
    leave the 132 SMs short (2 blocks to an SM for the 4-warp tiles, 1 for
    the 8- and 12-warp ones), K is split until they are full; no split where
    the tiles fill the card; at most 16 slices."""
    assert t_w8a8.grid(8, 4096, 11264, 11264) == (176, 2, 1)
    assert t_w8a8.grid(32, 4096, 11264, 11264) == (176, 2, 1)
    assert t_w8a8.grid(96, 2048, 16384, 2048) == (128, 1, 1)
    assert t_w8a8.grid(96, 16384, 2048, 2048) == (16, 8, 1)
    assert t_w8a8.grid(276, 2048, 16384, 2048) == (128, 1, 2)
    assert t_w8a8.grid(5, 1024, 4096, 1024) == (64, 4, 1)
    assert t_w8a8.slices(4, 16384, 256, 256) == 16
    for m, k, n, bn in ((8, 4096, 11264, 11264), (32, 4096, 11264, 11264),
                        (96, 2048, 16384, 2048), (96, 16384, 2048, 2048),
                        (276, 2048, 16384, 2048), (5, 1024, 4096, 1024)):
        cols, s, rows = t_w8a8.grid(m, k, n, bn)
        per_sm = 2 if m <= 64 else 1
        assert cols * s * rows >= 132 * per_sm * 15 // 16


# (M, K, N) of the split-half harnesses, then shapes that reach each path
# of K5: S 1 (M 276, the 144-row tile; K 38 and 100), 4, 8 and 16; the
# 96-row tile (M 96, 95, 65); 4-byte weight copies (N 260); x staged byte by
# byte (K/2 19, odd; 50; 1000; 500); the tile edges (M 1, 17, 64, 97, 145)
SPLIT_CUDA_SHAPES = [(8, 4096, 11264), (32, 4096, 11264), (96, 4096, 11264),
                     (276, 4096, 11264), (5, 38, 260), (3, 100, 260), (5, 1024, 4096),
                     (4, 16384, 2048), (4, 16384, 256), (1, 4096, 11264), (17, 2048, 2048),
                     (64, 2000, 260), (97, 1000, 260), (95, 2048, 4096), (65, 512, 1024),
                     (145, 256, 384)]


def _split_on(device, m, k, n, biased):
    x = _int8_on(device, (m, k), m)
    q = _int8_on(device, (k, n), k, -8, 8)
    packed = (lowbit.pack_split_half_biased if biased else lowbit.pack_split_half)(q)
    return x, q, packed, _scales(device, n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("m,k,n", SPLIT_CUDA_SHAPES)
def test_split_kernel_equals_plain_on_cuda(cuda_device, m, k, n, biased):
    x, q, packed, s = _split_on(cuda_device, m, k, n, biased)
    before = t_split.int4_split_matmul.launches
    out = t_split.int4_split_matmul(x, packed, s, biased=biased)
    torch.cuda.synchronize()
    assert t_split.int4_split_matmul.launches == before + 1
    assert torch.equal(out, t_split.int4_split_matmul_reference(x, packed, s, biased))
    want = (x.double() @ q.double()).float() * s
    assert torch.equal(out, want)
    assert torch.equal(out, t_split.int4_split_matmul(x, packed, s, biased))  # the same bits again


@pytest.mark.cuda
@pytest.mark.parametrize("biased", [False, True])
def test_split_kernel_graph_replay_gives_the_eager_bits(cuda_device, biased):
    x, _, packed, s = _split_on(cuda_device, 8, 4096, 11264, biased)
    eager = t_split.int4_split_matmul(x, packed, s, biased)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        t_split.int4_split_matmul(x, packed, s, biased)  # warm up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = t_split.int4_split_matmul(x, packed, s, biased)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_split_kernel_grid_fills_the_card_at_the_harness_shapes(cuda_device):
    """K4's rule on K/2: where the column tiles leave the 132 SMs short (2
    blocks to an SM for the 4-warp tiles, 1 for the larger ones), K/2 is
    split until they are full; no split where the tiles fill the card; at
    most 16 slices, of at least 64 packed rows."""
    assert t_split.grid(8, 4096, 11264) == (176, 2, 1)
    assert t_split.grid(32, 4096, 11264) == (176, 2, 1)
    assert t_split.grid(276, 4096, 11264) == (88, 1, 2)
    assert t_split.slices(5, 1024, 4096) == 4
    assert t_split.slices(4, 16384, 2048) == 8
    assert t_split.slices(4, 16384, 256) == 16
    assert t_split.slices(5, 38, 260) == 1
    for m in (8, 32):
        cols, s, rows = t_split.grid(m, 4096, 11264)
        assert cols * s * rows >= 132 * 2 * 15 // 16


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 32, 96])
def test_adjacent_int4_through_k2_on_cuda(cuda_device, m):
    x = _int8_on(cuda_device, (m, K), m)
    q = _int8_on(cuda_device, (K, NP), 3, -8, 8)
    s = _scales(cuda_device, NP, 4)
    out = lowbit.int4_adjacent_matmul(x, pack_int4(q), s)
    torch.cuda.synchronize()
    assert torch.equal(out, (x.double() @ q.double()).float() * s)


def _ffn_on(device, m, h, inter):
    g = torch.Generator(device=device).manual_seed(m)
    x = (torch.rand(m, h, device=device, generator=g) * 2 - 1).bfloat16()
    wg, wu = (torch.randn(h, inter, device=device, generator=g).mul_(0.02).bfloat16()
              for _ in range(2))
    wd = torch.randn(inter, h, device=device, generator=g).mul_(0.02).bfloat16()
    return x, wg, wu, wd


# the harness shape and two small ones; M 1, 17, 65, 277 and 300 (two row
# blocks), H 1920 (not a multiple of 256), I 64 (one column tile), a short
# last slice of K (I 1088)
FFN_CUDA_SHAPES = [(280, 2048, 16384), (40, 256, 1024), (3, 128, 64),
                   (1, 2048, 16384), (17, 256, 1024), (65, 128, 64), (277, 2048, 16384),
                   (300, 1024, 2048), (280, 1920, 1024), (280, 2048, 64), (17, 256, 1088)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,h,inter", FFN_CUDA_SHAPES)
def test_fused_ffn_kernel_within_one_bf16_step_on_cuda(cuda_device, m, h, inter):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wg, wu, wd = _ffn_on(cuda_device, m, h, inter)
    before = t_ffn.fused_ffn.launches
    out = t_ffn.fused_ffn(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert t_ffn.fused_ffn.launches == before + 1
    ref = t_ffn.fused_ffn_reference(x, wg, wu, wd).float()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert (out.float() - ref).abs().max().item() <= BF16_STEP * ref.abs().max().item()
    assert torch.equal(out, t_ffn.fused_ffn(x, wg, wu, wd))  # deterministic


@pytest.mark.cuda
def test_fused_ffn_graph_replay_gives_the_eager_bits(cuda_device):
    x, wg, wu, wd = _ffn_on(cuda_device, 280, 2048, 16384)
    eager = t_ffn.fused_ffn(x, wg, wu, wd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        t_ffn.fused_ffn(x, wg, wu, wd)  # warm up off the default stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = t_ffn.fused_ffn(x, wg, wu, wd)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,want", FFN_GRIDS)
def test_fused_ffn_kernel_grid_is_the_mirrored_grid(cuda_device, shape, want):
    assert t_ffn.kernel_grid(*shape) == t_ffn.grid(*shape) == want


@pytest.mark.cuda
def test_fused_ffn_cluster_table_is_the_cards(cuda_device):
    """The S rule's table of how many clusters fit at once is the card's, on
    an H100 SXM (132 SMs); elsewhere the rule still runs, less well fitted."""
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count != 132:
        pytest.skip("the table is an H100 SXM's")
    assert t_ffn.card_clusters() == t_ffn._CLUSTERS
