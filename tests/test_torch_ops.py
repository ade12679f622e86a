"""The port's tensor primitives (blurr_tpu_torch.ops) against the JAX ops
they replace, on the same numpy inputs, in fp32 on the CPU.

Tolerance atol = rtol = 1e-5 unless a case states another: both sides run
the same fp32 formulas, so only summation order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.ops import attention as j_attn
from blurr_tpu.ops import embeddings as j_emb
from blurr_tpu.ops import masks as j_masks
from blurr_tpu.ops import norms as j_norms
from blurr_tpu.ops import rotary as j_rot
from blurr_tpu.ops.activations import geglu as j_geglu
from blurr_tpu.ops.activations import silu as j_silu
from blurr_tpu_torch.ops import attention as t_attn
from blurr_tpu_torch.ops import embeddings as t_emb
from blurr_tpu_torch.ops import masks as t_masks
from blurr_tpu_torch.ops import norms as t_norms
from blurr_tpu_torch.ops import rotary as t_rot
from blurr_tpu_torch.ops.activations import geglu as t_geglu
from blurr_tpu_torch.ops.activations import silu as t_silu

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(t_out, j_out, **tol):
    np.testing.assert_allclose(
        t_out.detach().numpy(), np.asarray(j_out), **(tol or TOL)
    )


def test_rms_norm():
    x, w = _rand((2, 5, 32), 0, 3.0), _rand((32,), 1, 0.1)
    _close(
        t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
        j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w)),
    )


def test_rms_norm_bf16_bit_exact():
    """The fp32 island rounds once at the end, so bf16 agrees bit for bit."""
    x, w = _rand((3, 7, 64), 2, 3.0), _rand((64,), 3, 0.1)
    t = t_norms.rms_norm(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    )
    j = j_norms.rms_norm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    )
    np.testing.assert_array_equal(
        t.float().numpy(), np.asarray(j.astype(jnp.float32))
    )


def test_layer_norm():
    x = _rand((2, 6, 24), 4, 2.0) + 1.5
    w, b = _rand((24,), 5), _rand((24,), 6)
    _close(
        t_norms.layer_norm(*(torch.from_numpy(a) for a in (x, w, b))),
        j_norms.layer_norm(*(jnp.asarray(a) for a in (x, w, b))),
    )


@pytest.mark.parametrize("head_dim,base", [(16, 10000.0), (256, 10000.0), (32, 500.0)])
def test_rope(head_dim, base):
    pos = np.tile(np.arange(1, 12, dtype=np.int32), (2, 1))
    tc, ts = t_rot.rope_cos_sin(torch.from_numpy(pos), head_dim, base)
    jc, js = j_rot.rope_cos_sin(jnp.asarray(pos), head_dim, base)
    _close(tc, jc)
    _close(ts, js)
    x = _rand((2, 3, 11, head_dim), 7)
    _close(
        t_rot.apply_rope(torch.from_numpy(x), tc, ts),
        j_rot.apply_rope(jnp.asarray(x), jc, js),
    )


def test_activations():
    g, u = _rand((4, 33), 8, 3.0), _rand((4, 33), 9)
    _close(
        t_geglu(torch.from_numpy(g), torch.from_numpy(u)),
        j_geglu(jnp.asarray(g), jnp.asarray(u)),
    )
    _close(t_silu(torch.from_numpy(g)), j_silu(jnp.asarray(g)))


@pytest.mark.parametrize("dim", [16, 1024])
def test_sinusoidal_pos_emb(dim):
    t = np.array([0.0, 0.1, 0.55, 1.0], np.float32)
    _close(
        t_emb.sinusoidal_pos_emb(torch.from_numpy(t), dim),
        j_emb.sinusoidal_pos_emb(jnp.asarray(t), dim),
    )


def test_sinusoidal_pos_emb_keeps_t_dtype():
    t = torch.tensor([0.0, 0.5], dtype=torch.bfloat16)
    assert t_emb.sinusoidal_pos_emb(t, 32).dtype == torch.bfloat16


def test_pi0_masks_and_position_ids():
    am = np.zeros((3, 12), np.int32)
    for b, n in enumerate((5, 12, 1)):
        am[b, :n] = 1
    t_am, j_am = torch.from_numpy(am), jnp.asarray(am)
    np.testing.assert_array_equal(
        t_masks.pi0_prefix_mask(t_am, 12, 2).numpy(),
        np.asarray(j_masks.pi0_prefix_mask(j_am, 12, 2)),
    )
    np.testing.assert_array_equal(
        t_masks.pi0_action_mask(t_am, 12, 2, 4).numpy(),
        np.asarray(j_masks.pi0_action_mask(j_am, 12, 2, 4)),
    )
    for t_ids, j_ids in zip(
        t_masks.pi0_position_ids(3, 12, 2, 4, device=torch.device("cpu")),
        j_masks.pi0_position_ids(3, 12, 2, 4),
    ):
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))


def test_split_merge_heads_roundtrip():
    x = _rand((2, 5, 4 * 8), 10)
    t = t_attn.split_heads(torch.from_numpy(x), 4, 8)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j_attn.split_heads(jnp.asarray(x), 4, 8)))
    np.testing.assert_array_equal(t_attn.merge_heads(t).numpy(), x)


@pytest.mark.parametrize("softclamp", [None, 50.0])
@pytest.mark.parametrize(
    "b,nh,kvh,sq,skv,d",
    [(1, 4, 1, 9, 9, 16), (2, 4, 2, 5, 13, 8), (1, 8, 1, 4, 21, 32)],
)
def test_grouped_attention(b, nh, kvh, sq, skv, d, softclamp):
    q, k, v = _rand((b, nh, sq, d), 11), _rand((b, kvh, skv, d), 12), _rand((b, kvh, skv, d), 13)
    mask = np.random.RandomState(14).rand(b, sq, skv) > 0.3
    mask[:, -1, :] = False  # a fully masked (pad) row: uniform, finite
    out = t_attn.grouped_attention(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), softclamp
    )
    ref = j_attn.grouped_attention(*(jnp.asarray(a) for a in (q, k, v, mask)), softclamp)
    _close(out, ref)
    assert torch.isfinite(out).all()


def test_mha_flat():
    q, k, v = (_rand((2, 7, 3, 8), s) for s in (15, 16, 17))
    _close(
        t_attn.mha_flat(*(torch.from_numpy(a) for a in (q, k, v))),
        j_attn.mha_flat(*(jnp.asarray(a) for a in (q, k, v))),
    )
