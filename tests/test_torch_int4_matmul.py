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
