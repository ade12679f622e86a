"""The port's Pi-0 control step (blurr_tpu_torch.models.pi0) against the JAX
model on the same weights and inputs, on the CPU.

Set-up: JAX init_params -> tie_action_proprio_weights -> numpy ->
load_jax_params. Tolerances: fp32 actions atol 1e-4 (the same fp32
formulas summed in another order through 3 joint layers and 2 SigLIP
layers); bf16 actions atol 5e-2 (bf16 rounds at the same places on both
sides, but each rounding can land one ulp apart, ~4e-3 relative, and a few
compound).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0 import joint as j_joint
from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.models.pi0.siglip import siglip_forward
from blurr_tpu.ops import masks as j_masks
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import masks as t_masks
from tests.util import tiny_inputs, tiny_pi0_cfg


def _cfg(flash: bool, **overrides):
    cfg = tiny_pi0_cfg(**overrides)
    cfg.joint.config.use_flash_attn = flash
    return cfg


def _pair(cfg, dtype=jnp.float32):
    """(JAX model, JAX params, port model) on the same weights."""
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    params = jax.tree.map(lambda x: x.astype(dtype), params)
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), params)
    t_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = PiZero(cfg, device="cpu", dtype=t_dtype)
    load_jax_params(tm, tree)
    return jm, params, tm


def _inputs(cfg, dtype=jnp.float32):
    j_in = tiny_inputs(cfg)
    for key in ("pixel_values", "proprios", "noise"):
        j_in[key] = j_in[key].astype(dtype)
    t_in = {
        k: torch.from_numpy(np.array(v.astype(jnp.float32) if k in
                                     ("pixel_values", "proprios", "noise") else v))
        for k, v in j_in.items()
    }
    if dtype == jnp.bfloat16:
        for key in ("pixel_values", "proprios", "noise"):
            t_in[key] = t_in[key].bfloat16()
    return j_in, t_in


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("flash", [False, True])
def test_infer_action_fp32(flash, steps):
    cfg = _cfg(flash)
    jm, params, tm = _pair(cfg)
    j_in, t_in = _inputs(cfg)
    ref = np.asarray(jm.infer_action(params, **j_in, num_inference_steps=steps))
    out = tm.infer_action(**t_in, num_inference_steps=steps)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_tied_proprio_is_the_action_module():
    tm = PiZero(_cfg(False), device="cpu", dtype=torch.float32)
    assert tm.joint["proprio"] is tm.joint["action"]


def test_init_sets_every_weight_from_its_generator_only():
    """Building and initializing the model leave the process-wide torch
    generator untouched, and init_params writes every parameter."""
    state = torch.get_rng_state()
    tm = PiZero(_cfg(False), device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in tm.parameters():
            p.fill_(float("nan"))
    tm.init_params(torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.isfinite(p).all() for p in tm.parameters())


def test_siglip_features_and_prefill_cache():
    cfg = _cfg(False)
    jm, params, tm = _pair(cfg)
    j_in, t_in = _inputs(cfg)

    feats = tm.vision_tower(t_in["pixel_values"])
    j_feats = siglip_forward(params["siglip"], j_in["pixel_values"], jm.vision_cfg)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(j_feats), atol=1e-4)

    s = jm.spec
    bsz = j_in["input_ids"].shape[0]
    j_pos = j_masks.pi0_position_ids(
        bsz, s.max_image_text_tokens, s.num_proprio_tokens, s.num_action_tokens
    )
    j_k, j_v = j_joint.prefill(
        {"vlm": params["joint"]["vlm"], "proprio": params["joint"]["proprio"]},
        jm.joint_spec,
        {
            "vlm": jm._embed_merge(params, j_in["input_ids"], j_in["pixel_values"]),
            "proprio": jm._encode_proprio(params, j_in["proprios"]),
        },
        {"vlm": j_pos[0], "proprio": j_pos[1]},
        j_masks.pi0_prefix_mask(
            j_in["attention_mask"], s.max_image_text_tokens, s.num_proprio_tokens
        ),
    )
    t_pos = t_masks.pi0_position_ids(
        bsz, s.max_image_text_tokens, s.num_proprio_tokens, s.num_action_tokens,
        device=torch.device("cpu"),
    )
    with torch.no_grad():
        cache = t_joint.prefill(
            {"vlm": tm.joint["vlm"], "proprio": tm.joint["proprio"]},
            tm.joint_spec,
            {
                "vlm": tm._embed_merge(t_in["input_ids"], t_in["pixel_values"]),
                "proprio": tm._encode_proprio(t_in["proprios"]),
            },
            {"vlm": t_pos[0], "proprio": t_pos[1]},
            t_masks.pi0_prefix_mask(
                t_in["attention_mask"], s.max_image_text_tokens, s.num_proprio_tokens
            ),
        )
    assert len(cache) == cfg.joint.config.num_hidden_layers
    for i, (k, v) in enumerate(cache):
        np.testing.assert_allclose(k.numpy(), np.asarray(j_k[i]), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(j_v[i]), atol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
def test_blurr_preset_bf16(flash):
    """The blurr preset: bf16 weights and inputs, one flow step. Catches
    dtype-placement slips (the sqrt scalars, fp32 logits, bf16 time)."""
    cfg = _cfg(flash, use_bf16=True, num_inference_steps=1)
    jm, params, tm = _pair(cfg, jnp.bfloat16)
    j_in, t_in = _inputs(cfg, jnp.bfloat16)
    ref = np.asarray(jm.infer_action(params, **j_in).astype(jnp.float32))
    out = tm.infer_action(**t_in)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5e-2, rtol=0)


def test_long_prefix_goes_through_flash_attention(monkeypatch):
    """A 72-token image/text prefix (73 with proprio) reaches the Sq >= 64
    branch of the dispatch: flash_attention runs (its plain version on the
    CPU) on every prefill layer but the last, and the actions still agree.
    head_dim 32 is the smallest the kernel takes."""
    cfg = _cfg(True, max_image_text_tokens=72, max_seq_len=72)
    cfg.joint.config.head_dim = 32
    jm, params, tm = _pair(cfg)
    j_in, t_in = _inputs(cfg)
    calls = []
    real = t_joint.flash_attention

    def counting(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return real(q, *args, **kwargs)

    monkeypatch.setattr(t_joint, "flash_attention", counting)
    out = tm.infer_action(**t_in)
    ref = np.asarray(jm.infer_action(params, **j_in))
    n_layers = cfg.joint.config.num_hidden_layers
    assert calls == [(2, 2, 73, 32)] * (n_layers - 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_load_rejects_untied_tree():
    cfg = _cfg(False)
    jm = JPiZero(cfg)
    params = jm.init_params(jax.random.PRNGKey(0))  # proprio drawn apart
    tree = jax.tree.map(np.asarray, params)
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="not tied"):
        load_jax_params(tm, tree)


def test_unported_modes_raise():
    cfg = _cfg(False)
    cfg["action_quantization"] = {"mode": "w8a8"}
    with pytest.raises(NotImplementedError, match="action_quantization"):
        PiZero(cfg, device="cpu", dtype=torch.float32)
    cfg = _cfg(False)
    cfg.joint.config.mixture.action.adaptive_mode = "adaLN"
    with pytest.raises(NotImplementedError, match="adaLN"):
        PiZero(cfg, device="cpu", dtype=torch.float32)
