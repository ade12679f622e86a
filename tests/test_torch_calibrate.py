"""The port's GPTQ calibration for Pi-0 (``blurr_tpu_torch/models/pi0/
calibrate.py``) and ``joint.naive_forward(capture=True)`` against JAX's on
the CPU.

The tiny config quantized w4a8 (the vlm with ``include_vision`` and
``int8_keys`` down_w), JAX's random tree carried into the port by
``load_jax_params``; the calibration batch is ``tests/util.py:tiny_inputs``.
Capture is an observer: the action output is the same bits with it on. The
captures of both packages (two flow steps, the noise drawn from the same
``split`` chain) agree within ``CAPTURE_REL_TOL`` of each tensor's largest
|value| (the same fp32 formulas summed in other orders), the last layer
included, and the padded vlm rows are zero. ``gptq_quantize_pi0`` gives the
tree of JAX's: the same kinds per linear and layer, ``int8_keys`` at w8a8,
SigLIP at w8a8, the proprio mixture the action mixture; its levels and
scales within the bounds of ``tests/test_torch_gptq.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from blurr_tpu.models.pi0 import calibrate as j_cal
from blurr_tpu.models.pi0.pizero import PiZeroInference
from blurr_tpu_torch.models.pi0 import calibrate as t_cal
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import int4_matmul as t_int4
from blurr_tpu_torch.ops import quant as tq
from tests.test_torch_gptq import LEVEL_FRAC_TOL, SCALE_REL_TOL
from tests.util import tiny_inputs, tiny_pi0_cfg

CAPTURE_REL_TOL = 1e-5
FLOW_STEPS = 2
_MIX = {"q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
        "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj"}


def _cfg():
    cfg = tiny_pi0_cfg()
    cfg["vlm_quantization"] = {"mode": "w4a8", "include_vision": True, "int8_keys": ["down_w"]}
    cfg["action_quantization"] = {"mode": "w4a8"}
    return cfg


@functools.lru_cache(maxsize=1)
def _jax_side():
    cfg = _cfg()
    jm = PiZeroInference(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    batch = tiny_inputs(cfg)
    calib = j_cal.collect_pi0_calibration(jm, params, [batch], num_flow_steps=FLOW_STEPS,
                                          mixtures=("vlm", "action", "proprio"))
    return cfg, jm, params, batch, calib


def _port():
    cfg, _, params, batch, _ = _jax_side()
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return tm, {k: np.asarray(v) for k, v in batch.items() if k != "noise"}


def test_capture_changes_no_output():
    tm, batch = _port()
    args = [torch.from_numpy(batch[k]) for k in
            ("input_ids", "attention_mask", "pixel_values", "proprios")]
    noise = torch.from_numpy(np.asarray(_jax_side()[3]["noise"]))
    before = tm.infer_action_naive(*args, noise)
    real = t_joint.naive_forward

    def captured(*a, **kw):
        out, caps = real(*a, **kw, capture=True)
        assert torch.equal(out, real(*a, **kw))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_joint, "naive_forward", captured)
        assert torch.equal(tm.infer_action_naive(*args, noise), before)
    t_cal.collect_pi0_calibration(tm, [batch], num_flow_steps=FLOW_STEPS)
    assert torch.equal(tm.infer_action_naive(*args, noise), before)


def test_captures_match_jax():
    cfg, _, _, _, want = _jax_side()
    tm, batch = _port()
    got = t_cal.collect_pi0_calibration(tm, [batch], num_flow_steps=FLOW_STEPS,
                                        mixtures=("vlm", "action", "proprio"))
    n_layers = cfg["joint"]["config"]["num_hidden_layers"]
    am = batch["attention_mask"].reshape(-1).astype(bool)
    worst = 0.0
    for n in ("vlm", "action", "proprio"):
        assert got[n].keys() == want[n].keys() == {"attn_in", "o_in", "mlp_in", "down_in"}
        for key, x in want[n].items():
            assert tuple(got[n][key].shape) == x.shape and x.shape[0] == n_layers
            err = np.abs(got[n][key].numpy() - x).max() / np.abs(x).max()
            worst = max(worst, err)
            assert err < CAPTURE_REL_TOL, (n, key, err)
            assert np.abs(x[-1]).max() > 0  # the last layer's inputs are there
    for x in got["vlm"].values():  # the padded rows zero, in each flow step
        rows = x[0].numpy().reshape(FLOW_STEPS, -1, x.shape[-1])
        assert (rows[:, ~am] == 0).all() and (rows[:, am] != 0).any()
    print(f"captures within {worst:.2e} of each tensor's largest |value|")


def _levels(q4):
    return t_int4.unpack_int4_reference(t_int4.from_block_major(torch.as_tensor(np.asarray(q4))))


def test_gptq_tree_matches_jax():
    _, jm, params, batch, _ = _jax_side()
    theirs = jax.tree.map(np.asarray, j_cal.gptq_quantize_pi0(jm, params, [batch],
                                                             num_flow_steps=FLOW_STEPS))
    tm, t_batch = _port()
    assert t_cal.gptq_quantize_pi0(tm, [t_batch], num_flow_steps=FLOW_STEPS) is tm
    assert tm.joint["proprio"] is tm.joint["action"]
    for n in ("vlm", "action"):
        for key, attr in _MIX.items():
            leaf = theirs["joint"][n][key]
            for i, layer in enumerate(tm.joint[n].layers):
                mod = getattr(layer, attr)
                if "q8a" in leaf:
                    assert n == "vlm" and key == "down_w" and isinstance(mod, tq.W8A8Linear)
                    np.testing.assert_array_equal(mod.q8a.numpy(), leaf["q8a"][i])
                    continue
                assert isinstance(mod, tq.W4A8Linear) and set(leaf) == {"q4", "s"}
                assert tuple(mod.q4.shape) == leaf["q4"].shape[1:]
                assert tuple(mod.s.shape) == leaf["s"].shape[1:]
                s_j = leaf["s"][i]
                assert np.abs(mod.s.numpy() - s_j).max() / np.abs(s_j).max() < SCALE_REL_TOL
                apart = (_levels(mod.q4) != _levels(leaf["q4"][i])).float().mean()
                assert apart < LEVEL_FRAC_TOL, (n, key, i, float(apart))
    assert all(set(theirs["joint"]["proprio"][k]) == set(theirs["joint"]["action"][k])
               for k in _MIX)
    for layer in tm.vision_tower.layers:
        assert all(isinstance(getattr(layer, a), tq.W8A8Linear)
                   for a in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"))
    assert "q8a" in theirs["siglip"]["layers"]["fc1_w"]
    # the quantized model infers, through its w4a8 linears
    args = [torch.from_numpy(t_batch[k]) for k in
            ("input_ids", "attention_mask", "pixel_values", "proprios")]
    out = tm.infer_action(*args, torch.from_numpy(np.asarray(batch["noise"])))
    assert torch.isfinite(out).all()
