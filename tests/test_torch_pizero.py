"""The port's Pi-0 control step (blurr_tpu_torch.models.pi0) against the JAX
model on the same weights and inputs, on the CPU.

Set-up: JAX init_params -> tie_action_proprio_weights -> numpy ->
load_jax_params. Tolerances: fp32 actions atol 1e-4 (the same fp32
formulas summed in another order through 3 joint layers and 2 SigLIP
layers); bf16 actions atol 5e-2 (bf16 rounds at the same places on both
sides, but each rounding can land one ulp apart, ~4e-3 relative, and a few
compound). The w8a8 / w4a8 / int8 tiers run on JAX's quantized bytes,
carried over by load_jax_params, at the same tolerances. The port's int8
``{"q","s"}`` product is the int8 kernel, which rounds x to bf16; JAX's
``quant.mm`` dequantizes in XLA and does not, so that tier is held at 1e-4
against the JAX model whose ``{"q","s"}`` products go through the JAX
package's own kernel (``int8_mm_nd`` in interpret mode, patched in with
pytest's monkeypatch), and at 1e-2 against the JAX model as it is.
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
from blurr_tpu.ops import quant as j_quant
from blurr_tpu.ops.pallas_int8_matmul import int8_mm_nd
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import masks as t_masks
from blurr_tpu_torch.ops.quant import CachedFpLinear, Int8Linear
from tests import test_golden
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


@pytest.mark.parametrize("mode", ["adaLN", "adaLN-Zero"])
def test_adaptive_modes_build_and_run(mode):
    """The adaptive action expert builds and runs, cached and naive (its
    parity with JAX: tests/test_torch_adaln.py). The proprio mixture is the
    action module, so an expert adaptive in one of them only is refused."""
    cfg = _cfg(False)
    cfg.joint.config.mixture.action.adaptive_mode = mode
    with pytest.raises(ValueError, match="tied"):
        PiZero(cfg, device="cpu", dtype=torch.float32)
    cfg.joint.config.mixture.proprio.adaptive_mode = mode
    cfg.action_expert_adaptive_mode = mode
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    _, t_in = _inputs(cfg)
    for out in (tm.infer_action(**t_in), tm.infer_action_naive(**t_in)):
        assert out.shape == (2, 4, 7) and torch.isfinite(out).all()


@pytest.mark.parametrize("key,mode", [("action_quantization", "w4a4"),
                                      ("vlm_quantization", "int8"),
                                      ("kv_quantization", "w8a8")])
def test_unknown_modes_raise_value_error(key, mode):
    """A mode the JAX package does not know raises ValueError, as JAX's
    _checked_mode does (a misspelt mode is not "not ported yet")."""
    cfg = _cfg(False)
    cfg[key] = {"mode": mode}
    with pytest.raises(ValueError, match=f"{key}.mode"):
        JPiZero(cfg)
    with pytest.raises(ValueError, match=f"{key}.mode"):
        PiZero(cfg, device="cpu", dtype=torch.float32)


def _np(x):
    """A JAX leaf as numpy: int8 bytes as they are, floats as fp32."""
    return np.asarray(x if x.dtype == jnp.int8 else x.astype(jnp.float32))


def _quant_cfg(mode, clip=None, **overrides):
    cfg = _cfg(False, **overrides)
    cfg["vlm_quantization"] = {"mode": mode, "include_vision": True,
                               "activation_clip": clip}
    cfg["action_quantization"] = {"mode": mode, "activation_clip": clip}
    return cfg


def _quant_pair(cfg, dtype=jnp.float32):
    """(JAX model, JAX quantized params, port model holding the same
    quantized weights, carried over by load_jax_params)."""
    jm = JPiZero(cfg)
    params = jax.tree.map(lambda x: x.astype(dtype), jm.init_params(jax.random.PRNGKey(0)))
    params = jm.tie_action_proprio_weights(params)  # tied after the cast
    params = jm.enable_vlm_quantization(jm.enable_action_quantization(params))
    t_dtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tm = PiZero(cfg, device="cpu", dtype=t_dtype)
    tm.init_params(torch.Generator().manual_seed(0))
    tm.enable_action_quantization()
    tm.enable_vlm_quantization()
    load_jax_params(tm, jax.tree.map(_np, params))
    return jm, params, tm


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_quantized_infer_action_fp32(mode, clip):
    """vlm + action quantized (SigLIP w8a8 under include_vision), on JAX's
    quantized bytes; the clip of 1.0 bites on the tiny model's activations.
    atol 1e-4 as for the fp32 model: the int8 activations round alike."""
    cfg = _quant_cfg(mode, clip)
    jm, params, tm = _quant_pair(cfg)
    j_in, t_in = _inputs(cfg)
    ref = np.asarray(jm.infer_action(params, **j_in))
    out = tm.infer_action(**t_in)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)
    if clip is not None:  # the clamp bites: the same weights without it differ
        unclipped = JPiZero(_quant_cfg(mode)).infer_action(params, **j_in)
        assert not np.allclose(np.asarray(unclipped), ref, atol=1e-3)


@pytest.mark.parametrize("mode", ["w8a8", "w4a8"])
def test_quantized_preset_bf16(mode):
    """The quantized presets' dtype: bf16 weights quantized, one flow step."""
    cfg = _quant_cfg(mode, use_bf16=True, num_inference_steps=1)
    jm, params, tm = _quant_pair(cfg, jnp.bfloat16)
    j_in, t_in = _inputs(cfg, jnp.bfloat16)
    ref = np.asarray(jm.infer_action(params, **j_in).astype(jnp.float32))
    out = tm.infer_action(**t_in)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=5e-2, rtol=0)


@pytest.mark.parametrize("mode,golden_a00,golden_sum", [
    ("w8a8", test_golden.GOLDEN_W8A8_A00, test_golden.GOLDEN_W8A8_SUM),
    ("w4a8", test_golden.GOLDEN_W4A8_A00, test_golden.GOLDEN_W4A8_SUM),
])
def test_quantized_goldens(mode, golden_a00, golden_sum):
    """The port quantizes the fp32 JAX weights itself and reproduces the JAX
    package's quantized goldens (tests/test_golden.py) at their tolerance."""
    cfg = _cfg(False)
    cfg["vlm_quantization"] = {"mode": mode}
    cfg["action_quantization"] = {"mode": mode}
    _, _, tm = _pair(cfg)
    tm.enable_action_quantization()
    tm.enable_vlm_quantization()
    _, t_in = _inputs(cfg)
    a = tm.infer_action(**t_in).numpy()
    np.testing.assert_allclose(a[0, 0], golden_a00, atol=0.02)
    np.testing.assert_allclose(float(a.sum()), golden_sum, rtol=0.02)


def test_clips_stay_with_their_mixture():
    """The action clip goes to the action and proprio mixtures only, the vlm
    clip to the vlm mixture only, and a clip without its mode is dropped."""
    cfg = _cfg(False)
    cfg["action_quantization"] = {"mode": "w4a8", "activation_clip": 1.5}
    cfg["vlm_quantization"] = {"mode": "w8a8"}
    mix = PiZero(cfg, device="cpu", dtype=torch.float32).joint_spec.mixtures
    assert (mix["action"].activation_clip, mix["proprio"].activation_clip,
            mix["vlm"].activation_clip) == (1.5, 1.5, None)
    cfg["action_quantization"] = {"mode": None, "activation_clip": 1.5}
    cfg["vlm_quantization"] = {"mode": "w4a8", "activation_clip": 0.5}
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    mix = tm.joint_spec.mixtures
    assert (mix["action"].activation_clip, mix["vlm"].activation_clip) == (None, 0.5)
    assert tm.encoder_activation_clip is None
    jm = JPiZero(cfg)
    assert {n: m.activation_clip for n, m in jm.joint_spec.mixtures.items()} == {
        n: m.activation_clip for n, m in mix.items()}


def test_quantization_replaces_the_fp_weights():
    """After enable_*_quantization no mixture or SigLIP layer holds an fp
    matrix: the resident bytes of those linears are the int8 ones."""
    cfg = _quant_cfg("w4a8")
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    fp_bytes = sum(p.numel() * p.element_size() for p in tm.parameters())
    tm.enable_action_quantization()
    tm.enable_vlm_quantization()
    layers = [*tm.joint["vlm"].layers, *tm.joint["action"].layers, *tm.vision_tower.layers]
    assert not any(type(m) is torch.nn.Linear for layer in layers for m in layer.children())
    q_bytes = sum(t.numel() * t.element_size()
                  for t in [*tm.parameters(), *tm.buffers()])
    assert q_bytes < fp_bytes


def test_load_rejects_another_kind_of_weight():
    cfg = _quant_cfg("w4a8")
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    qtree = jax.tree.map(_np, jm.enable_action_quantization(params))
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="W4A8Linear"):
        load_jax_params(tm, qtree)  # the model is not quantized
    tm.enable_action_quantization()
    with pytest.raises(ValueError, match="plain weight"):
        load_jax_params(tm, jax.tree.map(_np, params))  # the tree is not
    cfg8 = _quant_cfg("w8a8")
    tm8 = PiZero(cfg8, device="cpu", dtype=torch.float32)
    tm8.enable_action_quantization()
    with pytest.raises(ValueError, match="W8A8Linear"):
        load_jax_params(tm8, qtree)


# ---------------------------------------------------------------------------
# The int8 tier: int8 weight-only {"q","s"} or cached-fp {"fp"}, int8 KV cache
# ---------------------------------------------------------------------------


def _route_jax_through_k3(monkeypatch):
    """Route the JAX model's {"q","s"} products through the JAX package's own
    int8 kernel (int8_mm_nd, interpret mode) instead of its XLA dequant;
    nothing in the package is edited."""
    real_mm = j_quant.mm

    def mm(x, w, activation_clip=None):
        if isinstance(w, dict) and set(w) == {"q", "s"}:
            if activation_clip is not None:
                x = jnp.clip(x, -activation_clip, activation_clip)
            return int8_mm_nd(x, w, interpret=True)
        return real_mm(x, w, activation_clip)

    monkeypatch.setattr(j_quant, "mm", mm)
    monkeypatch.setattr(j_joint, "mm", mm)


@pytest.fixture
def jax_through_k3(monkeypatch):
    _route_jax_through_k3(monkeypatch)


def _int8_cfg(cache_fp: bool, mode="int8", kv=True, clip=1.0, **overrides):
    """The bridge_pool64_steps2 tier on the tiny model: action int8 with the
    activation clip, the int8 KV cache with clip 1.0 dequantized to bf16."""
    cfg = _cfg(False, **overrides)
    cfg["action_quantization"] = {"mode": mode, "activation_clip": clip,
                                  "cache_fp_weight": cache_fp}
    if kv:
        cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0,
                                  "dtype": "bfloat16"}
    return cfg


def test_int8_cached_fp_with_kv_int8_fp32():
    """(a) The preset's own tier: cached-fp weights (a bf16 copy, also in an
    fp32 model) and the int8 KV cache, against JAX at atol 1e-4."""
    cfg = _int8_cfg(cache_fp=True)
    jm, params, tm = _quant_pair(cfg)
    assert isinstance(tm.joint["action"].layers[0].gate_proj, CachedFpLinear)
    assert tm.joint["action"].layers[0].gate_proj.fp.dtype == torch.bfloat16
    assert isinstance(tm.action_encoder_w2, CachedFpLinear)
    j_in, t_in = _inputs(cfg)
    ref = np.asarray(jm.infer_action(params, **j_in))
    out = tm.infer_action(**t_in)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_int8_weights_with_kv_int8_fp32(monkeypatch):
    """(b) {"q","s"} through the port's int8 kernel (its plain version on the
    CPU) with the int8 KV cache: against the JAX model as it is at 1e-2,
    then against the JAX model routed through its int8 kernel at 1e-4."""
    cfg = _int8_cfg(cache_fp=False)
    jm, params, tm = _quant_pair(cfg)
    assert isinstance(tm.joint["action"].layers[0].q_proj, Int8Linear)
    assert isinstance(tm.action_encoder_w1, Int8Linear)
    j_in, t_in = _inputs(cfg)
    out = tm.infer_action(**t_in).numpy()
    xla = np.asarray(jm.infer_action(params, **j_in))
    np.testing.assert_allclose(out, xla, atol=1e-2, rtol=0)
    _route_jax_through_k3(monkeypatch)
    k3 = np.asarray(jm.infer_action(params, **j_in))
    np.testing.assert_allclose(out, k3, atol=1e-4, rtol=0)


def test_int8_tier_bf16_two_steps(monkeypatch):
    """(c) The same tier in bf16 with 2 flow steps, at the bf16 tolerance
    5e-2, against the JAX model as it is (whose quant.mm rounds s and the
    dequantized weight to bf16) and routed through its int8 kernel; each
    gap measured 1.17e-2, three bf16 ulps at 1.0."""
    cfg = _int8_cfg(cache_fp=False, use_bf16=True, num_inference_steps=2)
    jm, params, tm = _quant_pair(cfg, jnp.bfloat16)
    j_in, t_in = _inputs(cfg, jnp.bfloat16)
    out = tm.infer_action(**t_in)
    assert out.dtype == torch.bfloat16
    xla = np.asarray(jm.infer_action(params, **j_in).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), xla, atol=5e-2, rtol=0)
    _route_jax_through_k3(monkeypatch)
    k3 = np.asarray(jm.infer_action(params, **j_in).astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), k3, atol=5e-2, rtol=0)


def test_int8_actions_track_the_fp_model():
    """(d) tests/test_quant.py's criteria, reproduced by the port: int8
    weight-only action expert and int8 KV cache against the fp model on the
    same weights, correlation > 0.99 and mean |difference| < 0.1."""
    cfg = _int8_cfg(cache_fp=False, clip=None)
    cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0}
    _, _, tm = _pair(cfg)
    _, t_in = _inputs(cfg)
    ref = tm.infer_action(**t_in).numpy()
    tm.enable_action_quantization()
    quant = tm.infer_action(**t_in).numpy()
    assert np.isfinite(quant).all()
    assert np.corrcoef(quant.ravel(), ref.ravel())[0, 1] > 0.99
    assert np.abs(quant - ref).mean() < 0.1
    assert not np.array_equal(quant, ref)


@pytest.mark.parametrize("key,mode", [("action_quantization", "int8"),
                                      ("action_quantization", "int8_cached"),
                                      ("action_quantization", "bnb_int8"),
                                      ("kv_quantization", "int8")])
def test_int8_modes_build_and_run(jax_through_k3, key, mode):
    """The four modes that raised before the int8 tier was ported now build
    and run, each against the JAX model (routed through its int8 kernel) at
    1e-4. int8_cached and bnb_int8 are the int8 path, as in JAX."""
    cfg = _cfg(False)
    cfg[key] = {"mode": mode}
    jm, params, tm = _quant_pair(cfg)
    quantized = key == "action_quantization"
    assert isinstance(tm.joint["action"].layers[0].up_proj, Int8Linear) == quantized
    assert tm.kv_quant_mode == (mode if not quantized else None)
    j_in, t_in = _inputs(cfg)
    ref = np.asarray(jm.infer_action(params, **j_in))
    out = tm.infer_action(**t_in)
    assert out.shape == ref.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype,want", [("int4", None), ("float16", torch.bfloat16),
                                        ("torch.float32", torch.float32),
                                        ("bfloat16", torch.bfloat16), ("", None)])
def test_kv_dequant_dtype_is_read_whatever_the_mode(dtype, want):
    """kv_quantization.dtype is validated as JAX validates it, with the int8
    KV cache off: an unknown dtype raises ValueError in both packages, and
    float16 maps to bfloat16 in both."""
    cfg = _cfg(False)
    cfg["kv_quantization"] = {"mode": None, "dtype": dtype}
    if dtype == "int4":
        with pytest.raises(ValueError, match="kv_quantization.dtype"):
            JPiZero(cfg)
        with pytest.raises(ValueError, match="kv_quantization.dtype"):
            PiZero(cfg, device="cpu", dtype=torch.float32)
        return
    j_dtype = JPiZero(cfg).kv_dequant_dtype
    assert (None if j_dtype is None else str(jnp.dtype(j_dtype))) == (
        None if want is None else str(want).removeprefix("torch."))
    assert PiZero(cfg, device="cpu", dtype=torch.float32).kv_dequant_dtype == want


def test_load_int8_trees_and_refuse_another_kind():
    """(e) load_jax_params carries both int8 kinds over byte for byte, and
    refuses a tree of the other kind."""
    trees = {}
    for cache_fp in (False, True):
        cfg = _int8_cfg(cache_fp)
        jm, params, tm = _quant_pair(cfg)
        trees[cache_fp] = tree = jax.tree.map(_np, params)
        layer = tm.joint["action"].layers[1]
        if cache_fp:
            np.testing.assert_array_equal(
                layer.down_proj.fp.float().numpy(), tree["joint"]["action"]["down_w"]["fp"][1])
        else:
            np.testing.assert_array_equal(
                layer.down_proj.q.numpy(), tree["joint"]["action"]["down_w"]["q"][1])
            np.testing.assert_array_equal(
                tm.action_encoder_w3.s.numpy(), tree["action_encoder"]["w3"]["s"])
        np.testing.assert_array_equal(
            tm.action_encoder_w1.bias.detach().numpy(), tree["action_encoder"]["b1"])
    for cache_fp, other in ((False, "CachedFpLinear"), (True, "Int8Linear")):
        tm = PiZero(_int8_cfg(cache_fp), device="cpu", dtype=torch.float32)
        tm.enable_action_quantization()
        with pytest.raises(ValueError, match=other):
            load_jax_params(tm, trees[not cache_fp])


@pytest.mark.parametrize("kv_dtype", [None, "bfloat16"])
def test_decode_over_an_int8_cache_matches_jax(kv_dtype):
    """joint.decode over the same int8 cache bytes and scales (per layer in
    the port, stacked in JAX), dequantized in each layer to the action dtype
    or to bf16; in the fp32 model the bf16 cache and the fresh fp32 K/V
    concatenate to fp32 on both sides."""
    from blurr_tpu.ops.quant import quantize_kv_int8 as j_quantize_kv

    cfg = _cfg(False)
    jm, params, tm = _pair(cfg)
    s = jm.spec
    rng = np.random.RandomState(5)
    nl, kvh, hd = 3, cfg.joint.config.num_key_value_heads, cfg.joint.config.head_dim
    p = s.max_image_text_tokens + s.num_proprio_tokens
    k_all = jnp.asarray(rng.randn(nl, 2, kvh, p, hd).astype(np.float32) * 2)
    v_all = jnp.asarray(rng.randn(nl, 2, kvh, p, hd).astype(np.float32))
    (k_q, k_s), (v_q, v_s) = j_quantize_kv(k_all, 1.0), j_quantize_kv(v_all, 1.0)
    embeds = rng.randn(2, s.num_action_tokens, 16).astype(np.float32)
    am = np.ones((2, s.max_image_text_tokens), np.int32)
    am[0, 9:] = 0
    mask = j_masks.pi0_action_mask(jnp.asarray(am), s.max_image_text_tokens,
                                   s.num_proprio_tokens, s.num_action_tokens)
    pos = j_masks.pi0_position_ids(2, s.max_image_text_tokens, s.num_proprio_tokens,
                                   s.num_action_tokens)[2]
    j_dtype = {None: None, "bfloat16": jnp.bfloat16}[kv_dtype]
    ref = j_joint.decode(
        {"action": params["joint"]["action"]}, jm.joint_spec, jnp.asarray(embeds), pos,
        {"k": k_q, "v": v_q, "k_scale": k_s, "v_scale": v_s}, mask,
        kv_dequant_dtype=j_dtype,
    )
    t = lambda a: torch.from_numpy(np.array(a))
    cache = [t_joint.Int8KV(t(k_q[i]), t(v_q[i]), t(k_s[i]), t(v_s[i])) for i in range(nl)]
    with torch.no_grad():
        out = t_joint.decode(
            tm.joint["action"], tm.joint_spec, t(embeds), t(pos), cache, t(mask),
            {None: None, "bfloat16": torch.bfloat16}[kv_dtype],
        )
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
