"""The port's int8 dequant-matmul (blurr_tpu_torch.ops.int8_matmul) against the
JAX package's blurr_tpu.ops.pallas_int8_matmul on the CPU.

The plain version ``int8_matmul_reference`` is held against the Pallas
kernel in interpret mode, as tests/test_pallas_attention.py runs it. Both
round x to bf16 and multiply by int8 exactly; JAX sums in fp32, the plain
version in float64, so in fp32 they agree to rtol/atol 1e-5. With bf16 x the
outputs are bf16, and the two fp32 sums may round to neighbouring bf16
values: within one bf16 rounding (2^-8 relative) of the JAX output. The
CUDA kernel is held against the plain version by the ``cuda`` tests below,
which skip without a card (run them on the GPU with
``python -m pytest tests/test_torch_int8_matmul.py -m cuda``), and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.ops import pallas_int8_matmul as j_int8
from blurr_tpu_torch.ops import int8_matmul as t_int8

BF16_ROUNDING = 2.0**-8  # the unit roundoff of bf16 (8 significant bits)


def _operands(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 2).astype(np.float32)
    q = rng.randint(-128, 128, (k, n)).astype(np.int8)
    s = (rng.rand(n) * 2e-3 + 1e-4).astype(np.float32)
    return x, q, s


def _torch(x, q, s, dtype):
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(q), torch.from_numpy(s))


def _assert_close(got, want, dtype):
    """fp32: rtol/atol 1e-5; bf16: one bf16 rounding of each output."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert (np.abs(got - want) <= BF16_ROUNDING * np.abs(want) + 1e-6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [130, 256])
@pytest.mark.parametrize("k", [7, 96])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_reference_matches_pallas_interpret(m, k, n, dtype):
    x, q, s = _operands(m, k, n, seed=m * 1000 + k + n)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(j_int8.int8_matmul(
        jnp.asarray(x).astype(jdtype), jnp.asarray(q), jnp.asarray(s), interpret=True
    ).astype(jnp.float32))
    got = t_int8.int8_matmul(*_torch(x, q, s, dtype))
    assert got.dtype == dtype and got.shape == (m, n)
    _assert_close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mm_nd_matches_jax(dtype):
    """x [2, 5, 96] through int8_mm_nd, against JAX's int8_mm_nd."""
    x, q, s = _operands(10, 96, 130, seed=3)
    x = x.reshape(2, 5, 96)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(j_int8.int8_mm_nd(
        jnp.asarray(x).astype(jdtype), {"q": jnp.asarray(q), "s": jnp.asarray(s)},
        interpret=True,
    ).astype(jnp.float32))
    tx, tq, ts = _torch(x, q, s, dtype)
    got = t_int8.int8_mm_nd(tx, {"q": tq, "s": ts})
    assert got.shape == (2, 5, 130) and got.dtype == dtype
    _assert_close(got.float().numpy(), want, dtype)


def test_reference_is_the_float64_sum_rounded_once():
    """Against numpy: bf16-rounded x times int8 summed in float64, rounded
    to fp32, times the scale in fp32; the port equals it bit for bit."""
    x, q, s = _operands(5, 64, 40, seed=7)
    xb = torch.from_numpy(x).bfloat16().float().numpy().astype(np.float64)
    want = (xb @ q.astype(np.float64)).astype(np.float32) * s
    got = t_int8.int8_matmul(*_torch(x, q, s, torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(2, 8)
    q = torch.zeros(8, 4, dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_int8.int8_matmul(x.double(), q, s)
    with pytest.raises(ValueError, match="int8"):
        t_int8.int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="s must be float32"):
        t_int8.int8_matmul(x, q, s.bfloat16())
    with pytest.raises(ValueError, match="shapes"):
        t_int8.int8_matmul(torch.zeros(2, 7), q, s)
    with pytest.raises(ValueError, match="shapes"):
        t_int8.int8_matmul(x, q, torch.ones(5))
    with pytest.raises(ValueError, match="shapes"):
        t_int8.int8_matmul(torch.zeros(0, 8), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        t_int8.int8_matmul(torch.zeros(8, 2).t(), q, s)
    with pytest.raises(ValueError, match="takes"):
        t_int8.int8_matmul(x[None], q, s)


def test_cpu_path_does_not_count_launches():
    before = t_int8.int8_matmul.launches
    t_int8.int8_matmul(torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.int8), torch.ones(4))
    assert t_int8.int8_matmul.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (M, K, N) of every int8 linear of the Pi-0 int8 step (action q, k/v, o,
# gate/up, down at M 1 and 4; the action encoder's w1, w2, w3 at M 4), and
# ragged ones: N not a multiple of 16 (byte loads), M past one row tile; the
# split of K: K 4096 at M 16 and 20 (N 1040: a last column tile of 16), K
# not a multiple of the slice (1000: 8 slices of 128, the last 104 rows;
# 4100: 16 slices of 272, longer than one 256-row chunk, the last 20 rows),
# one slice of 8 and of 4 chunks (M 64 and 300)
CUDA_SHAPES = [
    (1, 1024, 2048), (4, 1024, 2048), (1, 1024, 256), (4, 1024, 256),
    (1, 2048, 1024), (4, 2048, 1024), (1, 1024, 4096), (4, 1024, 4096),
    (1, 4096, 1024), (4, 4096, 1024), (4, 7, 1024), (4, 2048, 1024),
    (4, 1024, 1024), (37, 96, 130), (3, 300, 7), (20, 513, 260),
    (16, 4096, 1024), (20, 4096, 1040), (4, 1000, 1024), (4, 4100, 256),
    (64, 2048, 4096), (300, 1024, 1024),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", CUDA_SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, m, k, n, dtype):
    """fp32: within 1e-5 of the largest output (the kernel's fp32 sum against
    the plain version's float64 one); bf16: one bf16 rounding of each output
    of the plain version taken in fp32."""
    x, q, s = (t.to(cuda_device) for t in _torch(*_operands(m, k, n, seed=m + k + n), dtype))
    before = t_int8.int8_matmul.launches
    out = t_int8.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert t_int8.int8_matmul.launches == before + 1
    assert out.dtype == dtype and torch.isfinite(out).all()
    ref = t_int8.int8_matmul_reference(x.float(), q, s)  # fp32 output
    bound = 1e-5 * ref.abs().max()
    if dtype == torch.bfloat16:
        bound = bound + BF16_ROUNDING * ref.abs()
    assert ((out.float() - ref).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 4096), (4, 4096, 1024), (1, 2048, 1024),
                                   (20, 513, 260), (64, 2048, 4096)])
def test_kernel_gives_the_same_bits_twice_on_cuda(cuda_device, m, k, n, dtype):
    """The S sums are added in slice order by one thread per output, with no
    atomics: two calls give the same bits."""
    x, q, s = (t.to(cuda_device) for t in _torch(*_operands(m, k, n, seed=k), dtype))
    first = t_int8.int8_matmul(x, q, s)
    second = t_int8.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,want", [
    (4, 1024, 4096, 4), (4, 4096, 1024, 16), (1, 1024, 256, 16), (4, 7, 1024, 1),
    (4, 1000, 1024, 8), (4, 4100, 256, 16), (20, 513, 260, 8), (300, 1024, 1024, 1),
])
def test_split_of_k_on_cuda(cuda_device, m, k, n, want):
    """S, a power of two up to 16 (the cluster), fills ~256 blocks with
    slices of at least 64 rows, where K allows it."""
    assert t_int8.slices(m, k, n) == want
