"""The port's flash attention (blurr_tpu_torch.ops.flash_attention).

On the CPU its wrapper runs the plain PyTorch version; that is held against
the JAX Pallas kernel in interpret mode at the shapes of
tests/test_pallas_attention.py, at the same atol = rtol = 2e-4. A torch
mirror of each kernel's algorithm (query heads folded into rows, key tiles,
the key split and its fixed-order merge) is held against the Pallas kernel:
the bf16 kernel's with fp32 P and, with P rounded for P V, against the
plain version; the fp32 kernel's with its 3xTF32 products (each operand
split into a TF32 high part and a TF32 residual) at 1e-5, and a witness
with the high parts' product alone must miss that. On a fully masked row
the port follows JAX's XLA attention, not the Pallas kernel's padded keys;
a test pins that difference. The CUDA kernel itself is held against the
plain version by the ``cuda`` tests below, which skip without a card (run
them on the GPU with ``python -m pytest tests/test_torch_flash_attention.py
-m cuda``), and by chip_smoke.py.
"""

import functools
import pathlib
import re

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
# fp32 on the card also at the naive step's 281 rows over 4 requests (a
# batched baseline server's bucket)
CUDA_FP32_SHAPES = CUDA_SHAPES + [(4, 8, 1, 281, 281, 256)]
KEY_TILE = 64  # keys per staged K/V tile of the bf16 kernel
FP32_KEY_TILE = 32  # keys per staged K/V tile of the fp32 kernel
# the fp32 kernel against an exact fp32 attention: 3xTF32 keeps about 21
# bits of each product (the residuals' product, below 2^-22 of it, is
# dropped), so the outputs stay within a few fp32 roundings of the exact
# function (~2e-7 here); one TF32 product keeps 11 bits and reads ~1e-4 at
# q and k x0.3, ~4e-4 at x1.0. 1e-5 sits between the two.
FP32_EXACT_TOL = 1e-5
PI0 = SHAPES[2]


def _inputs(b, nh, kvh, sq, skv, d, qk_scale=0.3):
    rs = np.random.RandomState
    q = (rs(0).randn(b, nh, sq, d) * qk_scale).astype(np.float32)
    k = (rs(1).randn(b, kvh, skv, d) * qk_scale).astype(np.float32)
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


def _matmul(a, b):
    return a @ b


def _tf32(x):
    """``cvt.rna.tf32.f32``: x rounded to 10 mantissa bits, ties away from
    zero (half of the 13 dropped bits added to the bit pattern, then those
    bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(terms):
    """a @ b on TF32 operands: with ``terms`` 3 the kernel's 3xTF32 (each
    operand split into hi = tf32(x) and lo = tf32(x - hi); hi hi + hi lo +
    lo hi, the residuals' product dropped), with 1 hi hi alone."""

    def mm(a, b):
        ah, bh = _tf32(a), _tf32(b)
        out = ah @ bh
        if terms == 3:
            out = (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + out
        return out

    return mm


def _by_halves(mm):
    """a @ b as the fp32 kernel takes S = Q K^T: the two warps of a row
    group each sum one half of the head dim, and their sums are added."""

    def halves(a, b):
        h = a.shape[-1] // 2
        return mm(a[..., :h], b[..., :h, :]) + mm(a[..., h:], b[..., h:, :])

    return halves


def _mirror(q, k, v, mask, parts, p_dtype, softclamp=DEFAULT_SOFTCLAMP,
            key_tile=KEY_TILE, qk=_matmul, pv=_matmul):
    """A kernel's algorithm in torch, fp32 but for P and the products: the
    query heads of a KV group folded into rows (row r is head r // Sq at
    query r % Sq, mask row r % Sq); the keys split into ``parts`` parts of
    ceil(Skv / parts) keys, each walked in tiles of ``key_tile`` keys with
    its own online (m, l, O) and P rounded to ``p_dtype`` for P V (l sums
    the fp32 p); then the parts merged in part order. ``qk`` and ``pv`` take
    the products S = Q K^T and P V."""
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
        for k0 in range(kb, ke, key_tile):
            k1 = min(ke, k0 + key_tile)  # keys past the part take no part
            s = qk(qf, kf[:, :, k0:k1].transpose(-1, -2)) * d**-0.5
            if softclamp is not None:
                s = torch.tanh(s / softclamp) * softclamp
            s = torch.where(mask_rows[..., k0:k1], s, big_neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            o = o * alpha[..., None] + pv(p.to(p_dtype).float(), vf[:, :, k0:k1])
            m = m_new
        partial.append((m, l, o))
    _, l, o = _merge(partial)
    return (o / l.clamp_min(1e-30)[..., None]).reshape(b, nh, sq, d)


def _mirror_fp32(q, k, v, mask, parts, terms=3, softclamp=DEFAULT_SOFTCLAMP):
    """The fp32 kernel's algorithm: the fold and the key split of the bf16
    kernel, 32-key tiles, P kept in fp32, and both products on TF32
    operands (``terms`` 3: the kernel's 3xTF32)."""
    mm = _tf32_matmul(terms)
    return _mirror(q, k, v, mask, parts, torch.float32, softclamp,
                   key_tile=FP32_KEY_TILE, qk=_by_halves(mm), pv=mm)


@functools.lru_cache(maxsize=None)
def _pallas_at(shape, qk_scale=0.3):
    q, k, v, mask = _inputs(*shape, qk_scale=qk_scale)
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
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", SHAPES)
def test_fp32_mirror_3xtf32_matches_pallas_interpret(b, nh, kvh, sq, skv, d, parts):
    """The fp32 kernel's algorithm (3xTF32 products, 32-key tiles, the fold
    and the key split) is the Pallas kernel's function within
    FP32_EXACT_TOL."""
    q, k, v, mask = _inputs(b, nh, kvh, sq, skv, d)
    out = _mirror_fp32(*(torch.from_numpy(a) for a in (q, k, v, mask)), parts)
    err = np.abs(out.numpy() - _pallas_at((b, nh, kvh, sq, skv, d))).max()
    assert err <= FP32_EXACT_TOL, err


@pytest.mark.parametrize("qk_scale", [0.3, 1.0])
@pytest.mark.parametrize("terms", [3, 1])
def test_fp32_mirror_sees_a_lost_correction_term(terms, qk_scale):
    """At the Pi-0 prefill shape (3 key parts, as the card splits it), with
    q and k x0.3 and x1.0 (logits of std ~0.1 and ~1): 3xTF32 holds
    FP32_EXACT_TOL; the high parts' product alone (a plain TF32 kernel)
    misses it by 5x or more, so the tolerance sees a dropped term."""
    q, k, v, mask = _inputs(*PI0, qk_scale=qk_scale)
    out = _mirror_fp32(*(torch.from_numpy(a) for a in (q, k, v, mask)), 3, terms)
    err = np.abs(out.numpy() - _pallas_at(PI0, qk_scale)).max()
    if terms == 3:
        assert err <= FP32_EXACT_TOL, err
    else:
        assert err >= 5 * FP32_EXACT_TOL, err


def _kernel_tanh_coefficients():
    """The coefficients of the fp32 kernel's tanh polynomial, read from its
    source (highest degree first, as its Horner steps take them)."""
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "blurr_tpu_torch" / "csrc" / "flash_attention.cu").read_text()
    body = src[src.index("float tanh_fp32(float y)"):]
    body = body[:body.index("const float small")]
    return [float(c) for c in re.findall(r"(-?\d\.\d+e-?\d+)f", body)]


def _fma32(a, b, c):
    """fmaf in float32: one rounding of a * b + c (the product of two
    float32 is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def test_fp32_kernel_tanh_within_one_ulp():
    """The fp32 kernel's branch-free tanh, its polynomial taken from the
    source and evaluated in float32 as the kernel's Horner steps round it:
    within one ulp of tanh below |y| = 0.55; above it 1 - 2 / (e^(2|y|) + 1)
    with each operation rounded once, within one ulp too (the card's expf
    and division add their own few ulp, which the card's checks see)."""
    coef = _kernel_tanh_coefficients()
    assert len(coef) == 5
    a = np.concatenate([np.geomspace(1e-6, 0.55, 20001), np.linspace(0, 0.55, 20001)])
    a = a.astype(np.float32)
    t = (a.astype(np.float64) * a).astype(np.float32)
    p = np.full_like(a, coef[0])
    for c in coef[1:]:
        p = _fma32(p, t, np.float32(c))
    small = _fma32((p.astype(np.float64) * t).astype(np.float32), a, a)
    ref = np.tanh(a.astype(np.float64))
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(small - ref) <= ulp).all()
    y = np.linspace(0.55, 12, 20001).astype(np.float32)
    e = np.exp(2 * y.astype(np.float64)).astype(np.float32)
    q = (2.0 / (e.astype(np.float64) + 1)).astype(np.float32)
    big = (1 - q.astype(np.float64)).astype(np.float32)
    ref = np.tanh(y.astype(np.float64))
    assert (np.abs(big - ref) <= np.spacing(ref.astype(np.float32))).all()


def test_ablation_variants_apply_to_the_source():
    """scripts/ablate_flash_fp32_torch.py builds each variant of the fp32
    kernel by text substitution; every text it replaces is still in the
    source (the script refuses a variant whose text is gone)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "ablate_flash_fp32_torch.py"
    spec = importlib.util.spec_from_file_location("ablate_flash_fp32_torch", path)
    ablate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ablate)
    src = ablate.SOURCE.read_text()
    for name, (subs, _, _) in ablate.VARIANTS.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)


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


def _cuda_inputs(device, b, nh, kvh, sq, skv, d, dtype, qk_scale=0.3):
    """The test inputs on the card in ``dtype``, with some rows fully masked."""
    q, k, v, mask = (torch.from_numpy(a).to(device)
                     for a in _inputs(b, nh, kvh, sq, skv, d, qk_scale=qk_scale))
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
@pytest.mark.parametrize("qk_scale", [0.3, 1.0])
@pytest.mark.parametrize("b,nh,kvh,sq,skv,d", CUDA_FP32_SHAPES)
def test_fp32_kernel_within_exact_tol_of_plain(cuda_device, b, nh, kvh, sq, skv, d, qk_scale):
    """fp32 against the plain version (TF32 off) within FP32_EXACT_TOL, with
    q and k x0.3 and x1.0: a kernel that kept one TF32 product would miss
    it. The same bits on a second call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _cuda_inputs(cuda_device, b, nh, kvh, sq, skv, d, torch.float32, qk_scale)
    out = flash_attention(q, k, v, mask)
    again = flash_attention(q, k, v, mask)
    ref = flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    assert (out - ref).abs().max().item() <= FP32_EXACT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_kernel_every_head_dim_fp32(cuda_device, d, masked):
    """Every head_dim in fp32 within FP32_EXACT_TOL of the plain version,
    GQA 2:1 over a ragged 150 keys, with rows fully masked, and without a
    mask."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = _cuda_inputs(cuda_device, 2, 4, 2, 90, 150, d, torch.float32)
    if not masked:
        mask = None
    out = flash_attention(q, k, v, mask)
    ref = flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= FP32_EXACT_TOL


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


def _fp32_parts(b, nh, kvh, sq, skv, sms):
    """The fp32 kernel's key split: the parts (at most 8, at most one per
    32 keys) that minimize the waves of one block per SM times a block's
    32-key tiles plus one; the fewest on a tie."""
    tiles = -(-nh // kvh * sq // 64) * b * kvh
    most = max(1, min(8, -(-skv // 32)))
    cost = {p: -(-tiles * p // sms) * (1 + -(-(-(-skv // p)) // 32)) for p in range(1, most + 1)}
    return min(cost, key=lambda p: (cost[p], p))


@pytest.mark.cuda
def test_grid_at_the_prefill_shapes(cuda_device):
    """Both kernels fold the 8 heads into 64-row tiles and split the keys
    into parts of ceil(Skv / parts) keys; bf16 within one wave of one block
    per SM, fp32 as ``_fp32_parts`` chooses (at the naive step's 281 rows
    over 132 SMs 36 tiles x 3 parts of 94 keys, at 4 requests 3 parts
    too)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for sq in (277, 97, 281):
        (tiles, parts, groups), part_keys = grid(1, 8, 1, sq, sq, 256, torch.bfloat16)
        assert (tiles, groups) == (-(-8 * sq // 64), 1)
        assert 1 <= parts <= 8 and tiles * parts <= max(sms, tiles)
        assert part_keys == -(-sq // parts) and (parts - 1) * part_keys < sq
    for b, nh, kvh, sq, skv, d in CUDA_FP32_SHAPES + [(1, 8, 1, 276, 296, 256),
                                                      (2, 8, 1, 276, 296, 256)]:
        (tiles, parts, groups), part_keys = grid(b, nh, kvh, sq, skv, d, torch.float32)
        assert (tiles, groups) == (-(-nh // kvh * sq // 64), b * kvh)
        assert part_keys == -(-skv // parts) and (parts - 1) * part_keys < skv
        assert parts == -(-skv // -(-skv // _fp32_parts(b, nh, kvh, sq, skv, sms)))
    if sms == 132:
        assert grid(1, 8, 1, 281, 281, 256, torch.float32) == ((36, 3, 1), 94)
        assert grid(4, 8, 1, 281, 281, 256, torch.float32) == ((36, 3, 4), 94)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_bf16(cuda_device):
    q, k, v, mask = _cuda_inputs(cuda_device, 1, 2, 1, 64, 64, 32, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(shifted, k, v, mask)


@pytest.mark.cuda
def test_kernel_rejects_misaligned_fp32(cuda_device):
    """The fp32 kernel's 16-byte copies too take only aligned tensors."""
    q, k, v, mask = _cuda_inputs(cuda_device, 1, 2, 1, 64, 64, 32, torch.float32)
    shifted = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda_device)[1:].view(k.shape)
    shifted.copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, shifted, v, mask)
