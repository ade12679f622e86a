"""The port's naive control step (``PiZero.infer_action_naive``, the
``baseline`` preset's: no prefix cache, the whole joint model over image/text
+ proprio + action in every flow step) against the JAX package's on the CPU.

Same weights (JAX init_params -> tie_action_proprio_weights -> numpy ->
load_jax_params) and the same numpy inputs and noise on both sides.
Tolerances: fp32 rtol 1e-4, atol 1e-5 (the same formulas summed in another
order; the tiny model's actions differ by < 1e-6); bf16 atol 5e-2 as
``tests/test_torch_pizero.py`` states it (each bf16 rounding can land one
ulp apart and a few compound); the w8a8 tier atol 1e-4 as the cached tier's
test holds it. The cached and the naive step of the port agree in fp32 at
rtol 1e-4, atol 1e-5 (``tests/test_pizero.py``'s bound for JAX's pair).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.ops import masks as j_masks
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import masks as t_masks
from tests.util import tiny_inputs, tiny_pi0_cfg

FP32 = dict(rtol=1e-4, atol=1e-5)


def _pair(cfg, dtype=jnp.float32, quantize=False):
    """(JAX model, JAX params, port model) on the same weights."""
    jm = JPiZero(cfg)
    params = jax.tree.map(lambda x: x.astype(dtype), jm.init_params(jax.random.PRNGKey(0)))
    params = jm.tie_action_proprio_weights(params)
    t_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = PiZero(cfg, device="cpu", dtype=t_dtype)
    if quantize:
        params = jm.enable_vlm_quantization(jm.enable_action_quantization(params))
        tm.enable_action_quantization()
        tm.enable_vlm_quantization()
    load_jax_params(tm, jax.tree.map(
        lambda x: np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32)), params))
    return jm, params, tm


def _inputs(cfg, dtype=jnp.float32):
    j_in = tiny_inputs(cfg)
    t_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    t_in = {k: torch.from_numpy(np.array(v)) for k, v in j_in.items()}
    for key in ("pixel_values", "proprios", "noise"):
        j_in[key] = j_in[key].astype(dtype)
        t_in[key] = t_in[key].to(t_dtype)
    return j_in, t_in


def _long_cfg(flash: bool, **overrides):
    """A 72-token image/text prefix: 77 joint rows, so with ``flash`` the
    joint attention takes the Sq >= 64 branch (the kernel's plain version on
    the CPU). head_dim 32 is the smallest the kernel takes."""
    cfg = tiny_pi0_cfg(max_image_text_tokens=72, max_seq_len=72, **overrides)
    cfg.joint.config.head_dim = 32
    cfg.joint.config.use_flash_attn = flash
    return cfg


def test_full_mask_matches_jax():
    am = np.zeros((2, 12), np.int32)
    am[0, :7], am[1, :12] = 1, 1
    want = np.asarray(j_masks.pi0_full_mask(jnp.asarray(am), 12, 1, 4))
    got = t_masks.pi0_full_mask(torch.from_numpy(am), 12, 1, 4)
    assert got.dtype == torch.bool and tuple(got.shape) == (2, 17, 17)
    np.testing.assert_array_equal(got.numpy(), want)
    prefix = t_masks.pi0_prefix_mask(torch.from_numpy(am), 12, 1)
    assert torch.equal(got[:, :13, :13], prefix)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("flash", [False, True])
def test_infer_action_naive_fp32(flash, steps, monkeypatch):
    cfg = _long_cfg(flash)
    jm, params, tm = _pair(cfg)
    j_in, t_in = _inputs(cfg)
    calls = []
    real = t_joint.flash_attention

    def counting(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return real(q, *args, **kwargs)

    monkeypatch.setattr(t_joint, "flash_attention", counting)
    ref = np.asarray(jm.infer_action_naive(params, **j_in, num_inference_steps=steps))
    out = tm.infer_action_naive(**t_in, num_inference_steps=steps)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **FP32)
    # every layer of every flow step attends over all 77 rows
    n_layers = cfg.joint.config.num_hidden_layers
    assert calls == ([(2, 2, 77, 32)] * (n_layers * steps) if flash else [])


def test_infer_action_naive_bf16():
    cfg = tiny_pi0_cfg(use_bf16=True, num_inference_steps=2)
    jm, params, tm = _pair(cfg, jnp.bfloat16)
    j_in, t_in = _inputs(cfg, jnp.bfloat16)
    ref = np.asarray(jm.infer_action_naive(params, **j_in).astype(jnp.float32))
    out = tm.infer_action_naive(**t_in)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5e-2, rtol=0)


def test_infer_action_naive_w8a8_fp32():
    """vlm + action w8a8 (SigLIP w8a8 too) on JAX's quantized bytes."""
    cfg = tiny_pi0_cfg(num_inference_steps=2)
    cfg["vlm_quantization"] = {"mode": "w8a8", "include_vision": True}
    cfg["action_quantization"] = {"mode": "w8a8"}
    jm, params, tm = _pair(cfg, quantize=True)
    j_in, t_in = _inputs(cfg)
    ref = np.asarray(jm.infer_action_naive(params, **j_in))
    out = tm.infer_action_naive(**t_in)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("steps", [1, 4])
def test_cached_equals_naive_fp32(steps):
    """The prefix cache changes no action: the cached step and the naive
    step of the port on the same weights, inputs and noise."""
    cfg = tiny_pi0_cfg()
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    _, t_in = _inputs(cfg)
    cached = tm.infer_action(**t_in, num_inference_steps=steps)
    naive = tm.infer_action_naive(**t_in, num_inference_steps=steps)
    torch.testing.assert_close(naive, cached, **FP32)
