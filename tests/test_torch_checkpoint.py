"""The reference ``.pt`` checkpoints in the port
(``blurr_tpu_torch.models.pi0.checkpoint``) against the JAX package's torch
bridge (``blurr_tpu.models.pi0.checkpoint``) on the CPU, and the two
``ActionServer``s serving one checkpoint.

Every file is written into ``tmp_path``: by JAX's ``save_torch_checkpoint``
from a tiny JAX tree, or in the reference layout by
``tests/test_checkpoint_bridge.py:synth_torch_state``. Tolerances: fp32
actions rtol 1e-5, atol 1e-5 (the same weights, the same formulas summed in
another order: < 1e-6 apart on the tiny model); loaded and exported tensors
bit for bit; a loaded tree quantized w4a8 by the rule of
``tests/test_torch_quant.py`` (scale cells one ulp apart where JAX's
compiled ``amax * fp32(1/7)`` and the port's ``amax / 7`` round apart, the
int4 values equal everywhere else). The two servers: bf16 (blurr) atol
5e-2 as ``tests/test_torch_pizero.py`` states it, fp32 (baseline) atol 1e-4
(the served noise is JAX's within 4 fp32 ulps, ``tests/test_torch_prng.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0 import checkpoint as j_ckpt
from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.serving import server as j_server
from blurr_tpu_torch.models.pi0 import checkpoint as t_ckpt
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import quant as tq
from blurr_tpu_torch.presets import apply_preset
from blurr_tpu_torch.serving.server import ActionServer
from tests.test_checkpoint_bridge import synth_torch_state
from tests.test_torch_adaln import adaptive_cfg
from tests.test_torch_quant import _MIX, _check_w4a8_layer
from tests.util import tiny_inputs, tiny_pi0_cfg

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_tree(cfg):
    jm = JPiZero(cfg)
    return jm, jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))


def _inputs(cfg):
    j_in = tiny_inputs(cfg)
    return j_in, {k: torch.from_numpy(np.array(v)) for k, v in j_in.items()}


def _port(cfg, path, dtype=torch.float32):
    return t_ckpt.load_checkpoint(PiZero(cfg, device="cpu", dtype=dtype), str(path))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A tiny fp32 JAX tree written by JAX's save_torch_checkpoint."""
    cfg = tiny_pi0_cfg()
    jm, params = _jax_tree(cfg)
    path = tmp_path_factory.mktemp("ckpt") / "pi0.pt"
    j_ckpt.save_torch_checkpoint(params, str(path))
    return cfg, jm, params, path


@pytest.mark.parametrize("layout", ["model", "orig_mod", "bare"])
def test_load_matches_jax(saved, tmp_path, layout):
    """{"model": state} as JAX writes it; with the ``_orig_mod.`` prefix of
    a compiled module; and the bare state dict."""
    cfg, jm, _, path = saved
    if layout != "model":
        state = torch.load(path, weights_only=True)["model"]
        if layout == "orig_mod":
            state = {"model": {f"_orig_mod.{k}": v for k, v in state.items()}}
        path = tmp_path / f"{layout}.pt"
        torch.save(state, path)
    params = j_ckpt.load_pizero_params_auto(str(path), dtype=jnp.float32)
    tm = _port(cfg, path)
    j_in, t_in = _inputs(cfg)
    ref = np.asarray(jm.infer_action(params, **j_in, num_inference_steps=2))
    out = tm.infer_action(**t_in, num_inference_steps=2)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_load_casts_as_jax_does(saved):
    """bf16: each tensor is the fp32 checkpoint's rounded as JAX rounds it."""
    cfg, _, _, path = saved
    tm = _port(cfg, path, torch.bfloat16)
    params = j_ckpt.load_pizero_params_auto(str(path), dtype=jnp.bfloat16)
    mine = t_ckpt.torch_state_dict(tm)
    theirs = j_ckpt.torch_state_dict_from_pizero_params(params)
    assert mine.keys() == theirs.keys()
    for key, value in theirs.items():
        np.testing.assert_array_equal(mine[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("mode", [None, "adaLN-Zero"])
def test_exporter_matches_jax(mode):
    """The port's state dict of a model holding a JAX tree has JAX
    exporter's keys and bytes; an adaLN-Zero expert's adaptive keys too."""
    cfg = adaptive_cfg(mode) if mode else tiny_pi0_cfg()
    _, params = _jax_tree(cfg)
    tree = jax.tree.map(np.asarray, params)
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    t_ckpt.load_jax_params(tm, tree)
    mine = t_ckpt.torch_state_dict(tm)
    theirs = j_ckpt.torch_state_dict_from_pizero_params(tree)
    assert mine.keys() == theirs.keys()
    for key, value in theirs.items():
        assert mine[key].dtype == torch.float32
        np.testing.assert_array_equal(mine[key].numpy(), value, err_msg=key)
    if mode:
        assert any(k.endswith("post_adaptive_scale.to_adaln_zero_gamma.weight") for k in mine)


def test_save_then_load_is_the_identity(tmp_path):
    cfg = adaptive_cfg("adaLN")
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(1))
    t_ckpt.save_torch_checkpoint(tm, str(tmp_path / "a.pt"))
    back = _port(cfg, tmp_path / "a.pt")
    for (name, p), q in zip(tm.named_parameters(), back.parameters()):
        assert torch.equal(p, q), name


def _adaptive_reference_state(cfg, mode):
    """synth_torch_state with adaptive proprio / action mixtures, as
    tests/test_checkpoint_bridge.py:test_adaptive_checkpoint_bridge builds
    it, and the proprio mixture tied to the action mixture."""
    rng = np.random.RandomState(7)
    t = lambda *shape: torch.tensor(rng.randn(*shape).astype(np.float32) * 0.05)
    state = synth_torch_state(cfg)
    tc, jc = cfg.time_hidden_size, cfg.joint.config
    h = cfg.mixture.action.hidden_size
    mp = "joint_model.mixtures.action."
    for i in range(jc.num_hidden_layers):
        lp = mp + f"layers.{i}."
        for nm in ("input_layernorm", "post_attention_layernorm"):
            del state[lp + nm + ".weight"]
            state[lp + nm + ".to_gamma.0.weight"] = t(h, tc)
            state[lp + nm + ".to_gamma.0.bias"] = t(h)
            state[lp + nm + ".to_beta.weight"] = t(h, tc)
        if mode == "adaLN-Zero":
            for nm in ("post_adaptive_scale", "final_adaptive_scale"):
                state[lp + nm + ".to_adaln_zero_gamma.weight"] = t(h, tc)
                state[lp + nm + ".to_adaln_zero_gamma.bias"] = t(h)
    del state[mp + "norm.weight"]
    state[mp + "norm.to_gamma.0.weight"] = t(h, tc)
    state[mp + "norm.to_gamma.0.bias"] = t(h)
    state[mp + "norm.to_beta.weight"] = t(h, tc)
    state["action_encoder.linear_2.weight"] = t(h, h)
    for key in [k for k in state if k.startswith("joint_model.mixtures.proprio.")]:
        del state[key]
    for key in [k for k in state if k.startswith(mp)]:
        state[key.replace(".action.", ".proprio.")] = state[key]
    return state


@pytest.mark.parametrize("mode", ["adaLN", "adaLN-Zero"])
def test_adaptive_reference_checkpoint_matches_jax(tmp_path, mode):
    cfg = adaptive_cfg(mode)
    path = tmp_path / "adaptive.pt"
    torch.save({"model": _adaptive_reference_state(cfg, mode)}, path)
    jm = JPiZero(cfg)
    params = j_ckpt.pizero_params_from_torch_checkpoint(str(path), dtype=jnp.float32)
    tm = _port(cfg, path)
    j_in, t_in = _inputs(cfg)
    for infer in ("infer_action", "infer_action_naive"):
        ref = np.asarray(getattr(jm, infer)(params, **j_in, num_inference_steps=3))
        out = getattr(tm, infer)(**t_in, num_inference_steps=3)
        np.testing.assert_allclose(out.numpy(), ref, **TOL, err_msg=infer)


def test_refuses_what_it_cannot_serve(saved, tmp_path):
    """An untied checkpoint (synth_torch_state draws proprio apart), a
    missing key, a quantized model, and an orbax directory."""
    cfg, _, _, path = saved
    torch.save({"model": synth_torch_state(cfg)}, tmp_path / "untied.pt")
    with pytest.raises(ValueError, match="not tied"):
        _port(cfg, tmp_path / "untied.pt")
    state = torch.load(path, weights_only=True)["model"]
    del state["action_decoder.bias"]
    torch.save(state, tmp_path / "short.pt")
    with pytest.raises(ValueError, match="action_decoder.bias"):
        _port(cfg, tmp_path / "short.pt")
    qcfg = tiny_pi0_cfg()
    qcfg["action_quantization"] = {"mode": "w8a8"}
    tm = PiZero(qcfg, device="cpu", dtype=torch.float32).enable_action_quantization()
    with pytest.raises(ValueError, match="before quantizing"):
        t_ckpt.torch_state_dict(tm)
    with pytest.raises(NotImplementedError, match="M13"):
        _port(cfg, tmp_path)


def test_loaded_tree_quantized_w4a8_matches_jax(saved):
    path = saved[3]
    cfg = tiny_pi0_cfg()
    cfg["vlm_quantization"] = {"mode": "w4a8"}
    cfg["action_quantization"] = {"mode": "w4a8", "group_size": 16}
    jm = JPiZero(cfg)
    fp = j_ckpt.load_pizero_params_auto(str(path), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.enable_vlm_quantization(
        jm.enable_action_quantization(fp)))
    fp = jax.tree.map(np.asarray, fp)
    tm = _port(cfg, path).enable_action_quantization().enable_vlm_quantization()
    for name in ("vlm", "action"):
        for i, layer in enumerate(tm.joint[name].layers):
            for key, attr in _MIX.items():
                leaf, mod = tree["joint"][name][key], getattr(layer, attr)
                assert isinstance(mod, tq.W4A8Linear)
                _check_w4a8_layer(fp["joint"][name][key][i],
                                  {"q4": leaf["q4"][i], "s": leaf["s"][i]}, mod)


@pytest.mark.parametrize("preset,tol", [("blurr", 5e-2), ("baseline", 1e-4)])
def test_both_servers_serve_one_checkpoint(saved, preset, tol):
    """The slice as a whole: JAX's ActionServer and the port's load the same
    .pt with the same seed, and answer the same requests alike (both draw
    normal(fold_in(PRNGKey(seed), idx)) as the noise). The stub tokenizer's
    ids run to 999, so the model's vocabulary is widened to 1024."""
    _, _, _, path = saved
    cfg = tiny_pi0_cfg(vocab_size=1024, image_token_index=1000)
    jm, params = _jax_tree(cfg)
    path = path.with_name(f"wide_{preset}.pt")
    j_ckpt.save_torch_checkpoint(params, str(path))
    apply_preset(cfg, preset)
    jax_srv = j_server.ActionServer(cfg, str(path), seed=5)
    port_srv = ActionServer(cfg, str(path), device="cpu", seed=5)
    assert port_srv.stats()["checkpoint"] == str(path)
    size = cfg.vision.config.image_size
    rng = np.random.RandomState(0)
    for _ in range(2):
        image = rng.randint(0, 256, (size, size, 3), np.uint8)
        proprio = rng.uniform(-1, 1, 7).tolist()
        want = jax_srv.predict(image, "put the spoon on the towel", proprio)
        got = port_srv.predict(image, "put the spoon on the towel", proprio)
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=0)
