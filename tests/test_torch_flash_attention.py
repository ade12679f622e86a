"""The port's flash attention (blurr_tpu_torch.ops.flash_attention).

On the CPU its wrapper runs the plain PyTorch version; that is held against
the JAX Pallas kernel in interpret mode at the shapes of
tests/test_pallas_attention.py, at the same atol = rtol = 2e-4. A torch
mirror of the bf16 kernel's algorithm (query heads folded into rows, 64-key
tiles, the key split and its fixed-order merge, P rounded for P V) is held
against the Pallas kernel with fp32 P and against the plain version with
bf16 P. On a fully masked row the port follows JAX's XLA attention, not the
Pallas kernel's padded keys; a test pins that difference. The CUDA kernel
itself is held against the plain version by the ``cuda`` tests below, which
skip without a card (run them on the GPU with
``python -m pytest tests/test_torch_flash_attention.py -m cuda``), and by
chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.ops.attention import grouped_attention as jax_grouped_attention
from blurr_tpu.ops.pallas_attention import flash_attention as pallas_flash
from blurr_tpu_torch.ops.attention import DEFAULT_SOFTCLAMP
from blurr_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    grid,
)

SHAPES = [
    (1, 4, 1, 64, 64, 32),     # MQA, aligned
    (2, 4, 2, 100, 150, 64),   # GQA, ragged seq
    (1, 8, 1, 277, 277, 256),  # Pi-0 prefill shape
]
# and the pool64 prefill (96 image tokens + proprio), on the card
CUDA_SHAPES = SHAPES + [(1, 8, 1, 97, 97, 256)]
KEY_TILE = 64  # keys per staged K/V tile of the bf16 kernel


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


def _merge(partials):
    """The (m, l, O) of several key sets of the same rows, added in list
    order with the usual rescale."""
    m = partials[0][0]
    for mi, _, _ in partials[1:]:
        m = torch.maximum(m, mi)
    l, o = torch.zeros_like(m), torch.zeros_like(partials[0][2])
    for mi, li, oi in partials:
        w = torch.exp(mi - m)
        l = l + w * li
        o = o + w[..., None] * oi
    return m, l, o


def _mirror(q, k, v, mask, parts, p_dtype, softclamp=DEFAULT_SOFTCLAMP):
    """The bf16 kernel's algorithm in torch, fp32 but for P: the query heads
    of a KV group folded into rows (row r is head r // Sq at query r % Sq,
    mask row r % Sq); the keys split into ``parts`` parts of ceil(Skv /
    parts) keys, each walked in 64-key tiles with its own online (m, l, O)
    and P rounded to ``p_dtype`` for P V (l sums the fp32 p); then the parts
    merged in part order."""
    b, nh, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rows = nh // kvh * sq
    qf = q.float().reshape(b, kvh, rows, d)
    kf, vf = k.float(), v.float()
    mask_rows = mask[:, torch.arange(rows) % sq][:, None]  # [b, 1, rows, skv]
    big_neg = torch.finfo(torch.float32).min
    part_keys = -(-skv // parts)
    partial = []
    for kb in range(0, skv, part_keys):
        ke = min(skv, kb + part_keys)
        m = torch.full((b, kvh, rows), big_neg)
        l = torch.zeros(b, kvh, rows)
        o = torch.zeros(b, kvh, rows, d)
        for k0 in range(kb, ke, KEY_TILE):
            k1 = min(ke, k0 + KEY_TILE)  # keys past the part take no part
            s = torch.einsum("bkrd,bksd->bkrs", qf, kf[:, :, k0:k1]) * d**-0.5
            if softclamp is not None:
                s = torch.tanh(s / softclamp) * softclamp
            s = torch.where(mask_rows[..., k0:k1], s, big_neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            o = o * alpha[..., None] + p.to(p_dtype).float() @ vf[:, :, k0:k1]
            m = m_new
        partial.append((m, l, o))
    _, l, o = _merge(partial)
    return (o / l.clamp_min(1e-30)[..., None]).reshape(b, nh, sq, d)


@functools.lru_cache(maxsize=None)
def _pallas_at(shape):
    q, k, v, mask = _inputs(*shape)
    return np.asarray(pallas_flash(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                   softclamp=DEFAULT_SOFTCLAMP, interpret=True))


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", SHAPES)
def test_mirror_fp32_p_matches_pallas_interpret(b, nh, kvh, sq, skv, d, parts):
    """With P kept in fp32 the split, folded algorithm is the Pallas kernel's
    function, on every row that is not fully masked (here: all of them)."""
    q, k, v, mask = _inputs(b, nh, kvh, sq, skv, d)
    out = _mirror(*(torch.from_numpy(a) for a in (q, k, v, mask)), parts, torch.float32)
    ref = _pallas_at((b, nh, kvh, sq, skv, d))
    assert mask.any(-1).all()  # no row is fully masked here
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", SHAPES[1:])  # Skv 150 and 277
def test_mirror_bf16_p_within_bf16_tol_of_plain(b, nh, kvh, sq, skv, d, parts):
    """bf16 inputs and P rounded to bf16 stay within 2e-2 of the fp32 plain
    version, fully masked rows included; the last part may be short (277
    keys in parts of 93, 93, 91 at 3) and a part's last tile ragged (150 in
    parts of 75 at 2)."""
    q, k, v, mask = (torch.from_numpy(a) for a in _inputs(b, nh, kvh, sq, skv, d))
    mask[:, sq - 7 :, :] = False  # pad rows of the prompt
    q, k, v = (t.bfloat16().float() for t in (q, k, v))
    ref = flash_attention_reference(q, k, v, mask)
    out = _mirror(q, k, v, mask, parts, torch.bfloat16)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    # with fp32 P the mirror is the plain version up to fp32 sums
    out32 = _mirror(q, k, v, mask, parts, torch.float32)
    torch.testing.assert_close(out32, ref, rtol=2e-4, atol=2e-4)


def test_fully_masked_row_follows_xla_not_pallas_padding():
    """A fully masked row (a pad token): the port's wrapper on the CPU gives
    JAX's XLA ``grouped_attention`` (the uniform mean of V over the Skv
    keys); JAX's Pallas kernel pads the keys to 128 and its padded keys
    join that uniform softmax, so it gives Skv / Skv_p of it (16 / 128).
    Valid rows agree; no valid query attends a pad key."""
    q, k, v, mask = _inputs(1, 2, 1, 16, 16, 32)
    mask[:, 5:9, :] = False
    ours = flash_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    jq, jk, jv, jm = (jnp.asarray(a) for a in (q, k, v, mask))
    xla = np.asarray(jax_grouped_attention(jq, jk, jv, jm))
    pallas = np.asarray(pallas_flash(jq, jk, jv, jm, interpret=True))
    np.testing.assert_allclose(ours, xla, rtol=1e-5, atol=1e-5)
    uniform = np.broadcast_to(v.mean(axis=2)[:, :, None], (1, 2, 4, 32))
    np.testing.assert_allclose(xla[:, :, 5:9], uniform, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pallas[:, :, 5:9], xla[:, :, 5:9] * 16 / 128, rtol=1e-5, atol=1e-5)
    keep = np.r_[0:5, 9:16]
    np.testing.assert_allclose(pallas[:, :, keep], xla[:, :, keep], rtol=2e-4, atol=2e-4)


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


def _cuda_inputs(device, b, nh, kvh, sq, skv, d, dtype):
    """The test inputs on the card in ``dtype``, with some rows fully masked."""
    q, k, v, mask = (torch.from_numpy(a).to(device) for a in _inputs(b, nh, kvh, sq, skv, d))
    g = torch.Generator(device=device).manual_seed(4)
    rows = torch.rand(b, sq - sq // 2, 1, generator=g, device=device) > 0.2
    mask[:, sq // 2 :, :] &= rows  # some rows fully masked
    return q.to(dtype), k.to(dtype), v.to(dtype), mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", CUDA_SHAPES)
def test_kernel_matches_plain_on_cuda(cuda_device, b, nh, kvh, sq, skv, d, dtype, tol):
    """fp32 at 2e-4 (fp32 FMA sums in another order, TF32 off); bf16 inputs
    against the plain version in fp32 of the same inputs at 2e-2 (the bf16
    rounding of P and of the output)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _cuda_inputs(cuda_device, b, nh, kvh, sq, skv, d, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q.float(), k.float(), v.float(), mask)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_kernel_every_head_dim_bf16(cuda_device, d, masked):
    """Every head_dim in bf16, GQA 2:1 over a ragged 150 keys (a short last
    key part), with rows fully masked, and without a mask."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _cuda_inputs(cuda_device, 2, 4, 2, 90, 150, d, torch.bfloat16)
    if not masked:
        mask = None
    out = flash_attention(q, k, v, mask)
    ref = flash_attention_reference(q.float(), k.float(), v.float(), mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", CUDA_SHAPES)
def test_kernel_same_bits_and_one_launch_per_call(cuda_device, b, nh, kvh, sq, skv, d, dtype):
    """Two calls give the same bits (the key parts merge in a fixed order,
    no atomics), and each call counts one launch."""
    q, k, v, mask = _cuda_inputs(cuda_device, b, nh, kvh, sq, skv, d, dtype)
    before = flash_attention.launches
    first = flash_attention(q, k, v, mask)
    second = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_grid_at_the_prefill_shapes(cuda_device):
    """The bf16 grid folds the 8 heads into 64-row tiles and splits the keys
    into parts of ceil(Skv / parts) keys, within one wave of one block per
    SM."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for sq in (277, 97):
        (tiles, parts, groups), part_keys = grid(1, 8, 1, sq, sq, 256, torch.bfloat16)
        assert (tiles, groups) == (-(-8 * sq // 64), 1)
        assert 1 <= parts <= 8 and tiles * parts <= max(sms, tiles)
        assert part_keys == -(-sq // parts) and (parts - 1) * part_keys < sq
    assert grid(1, 8, 1, 277, 277, 256, torch.float32) == ((18, 8, 1), 0)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_bf16(cuda_device):
    q, k, v, mask = _cuda_inputs(cuda_device, 1, 2, 1, 64, 64, 32, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(shifted, k, v, mask)
