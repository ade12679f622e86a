"""The port's flash attention (blurr_tpu_torch.ops.flash_attention).

On the CPU its wrapper runs the plain PyTorch version; that is held against
the JAX Pallas kernel in interpret mode at the shapes of
tests/test_pallas_attention.py, at the same atol = rtol = 2e-4. The CUDA
kernel itself is held against the plain version by the ``cuda`` tests
below, which skip without a card (run them on the GPU with
``python -m pytest tests/test_torch_flash_attention.py -m cuda``), and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.ops.pallas_attention import flash_attention as pallas_flash
from blurr_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

SHAPES = [
    (1, 4, 1, 64, 64, 32),     # MQA, aligned
    (2, 4, 2, 100, 150, 64),   # GQA, ragged seq
    (1, 8, 1, 277, 277, 256),  # Pi-0 prefill shape
]


def _inputs(b, nh, kvh, sq, skv, d):
    rs = np.random.RandomState
    q = (rs(0).randn(b, nh, sq, d) * 0.3).astype(np.float32)
    k = (rs(1).randn(b, kvh, skv, d) * 0.3).astype(np.float32)
    v = rs(2).randn(b, kvh, skv, d).astype(np.float32)
    mask = rs(3).rand(b, sq, skv) > 0.3
    mask[:, :, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("softclamp", [None, 50.0])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", SHAPES)
def test_flash_matches_pallas_interpret(b, nh, kvh, sq, skv, d, softclamp):
    q, k, v, mask = _inputs(b, nh, kvh, sq, skv, d)
    out = flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), softclamp=softclamp
    )
    ref = pallas_flash(
        *(jnp.asarray(a) for a in (q, k, v, mask)), softclamp=softclamp,
        interpret=True,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_flash_fully_masked_rows_finite():
    q, k, v, mask = _inputs(1, 2, 1, 16, 16, 32)
    mask[:, 5:9, :] = False  # pad rows of the prompt
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert torch.isfinite(out).all()
    # a fully masked row averages V uniformly, as grouped_attention does
    np.testing.assert_allclose(
        out[0, 0, 6].numpy(), v[0, 0].mean(axis=0), rtol=1e-5, atol=1e-5
    )


def test_flash_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                        v[..., :24].contiguous(), mask)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), k.half(), v.half(), mask)
    with pytest.raises(ValueError, match="mask"):
        flash_attention(q, k, v, mask.float())


def test_cpu_path_does_not_count_launches():
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 8, 8, 32))
    before = flash_attention.launches
    flash_attention(q, k, v, mask)
    assert flash_attention.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, b, nh, kvh, sq, skv, d, dtype, tol):
    """fp32 at 2e-4 (fp32 FMA sums in another order, TF32 off); bf16 inputs
    against the plain version in fp32 of the same inputs at 2e-2 (the bf16
    rounding of the output)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = (
        torch.from_numpy(a).to(cuda_device) for a in _inputs(b, nh, kvh, sq, skv, d)
    )
    g = torch.Generator(device=cuda_device).manual_seed(4)
    rows = torch.rand(b, sq - sq // 2, 1, generator=g, device=cuda_device) > 0.2
    mask[:, sq // 2 :, :] &= rows  # some rows fully masked
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q.float(), k.float(), v.float(), mask)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
