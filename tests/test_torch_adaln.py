"""The port's adaptive (adaLN / adaLN-Zero) action expert against the JAX
package's on the CPU: the two norms, then the cached and the naive control
steps with the weights carried across by ``load_jax_params``.

JAX's init draws adaLN-Zero's gate weights as zeros, which would leave the
gates blind to the time; the tests redraw every adaptive leaf from numpy so
that each conditioning moves the actions. Tolerances: the norms rtol 1e-6,
atol 1e-6 (the same fp32 formulas, the 8-term linears of the conditioning
summed in another order, outputs up to ~10); the control steps fp32 rtol 1e-5, atol
1e-5 (the same formulas summed in another order through 3 joint and 2
SigLIP layers: < 1e-6 apart on the tiny model).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu.models.pi0.pizero import PiZero as JPiZero
from blurr_tpu.ops import norms as j_norms
from blurr_tpu_torch.models.pi0 import joint as t_joint
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import norms as t_norms
from tests.util import tiny_inputs, tiny_pi0_cfg

TOL = dict(rtol=1e-5, atol=1e-5)
_ADAPTIVE_LEAVES = ("to_gamma_w", "to_gamma_b", "to_beta_w", "gamma_w", "gamma_b")


def adaptive_cfg(mode, **overrides):
    """tiny_pi0_cfg with an adaptive proprio / action expert."""
    cfg = tiny_pi0_cfg(**overrides)
    cfg.action_expert_adaptive_mode = mode
    for mix in ("proprio", "action"):
        cfg.mixture[mix].adaptive_mode = mode
    cfg.joint.config.mixture = cfg.mixture
    cfg.joint.config.action_expert_adaptive_mode = mode
    return cfg


def adaptive_pair(mode, seed=3, **overrides):
    """(cfg, JAX model, JAX params, port model) on the same weights, the
    adaptive leaves redrawn N(0, 0.3^2) from numpy."""
    cfg = adaptive_cfg(mode, **overrides)
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)

    def redraw(d):
        for k, v in d.items():
            if isinstance(v, dict):
                redraw(v)
            elif k in _ADAPTIVE_LEAVES:
                d[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)

    redraw(tree["joint"]["action"])
    tree["joint"]["proprio"] = tree["joint"]["action"]
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(tm, tree)
    return cfg, jm, jax.tree.map(jnp.asarray, tree), tm


def _inputs(cfg):
    j_in = tiny_inputs(cfg)
    return j_in, {k: torch.from_numpy(np.array(v)) for k, v in j_in.items()}


@pytest.mark.parametrize("cond_rank", [2, 3])
def test_adaptive_norms_match_jax(cond_rank):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    cond = rng.randn(2, 8).astype(np.float32)
    if cond_rank == 3:
        cond = cond[:, None, :]
    gw, bw, sw = (rng.randn(8, 16).astype(np.float32) for _ in range(3))
    gb, sb = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    want = j_norms.adaptive_rms_norm(
        jnp.asarray(x), jnp.asarray(cond),
        {"to_gamma_w": gw, "to_gamma_b": gb, "to_beta_w": bw}, 1e-6)
    t = torch.from_numpy
    got = t_norms.adaptive_rms_norm(t(x), t(cond), t(gw.T.copy()), t(gb), t(bw.T.copy()), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = j_norms.adaptive_layerscale(
        jnp.asarray(x), jnp.asarray(cond), {"gamma_w": sw, "gamma_b": sb})
    got = t_norms.adaptive_layerscale(t(x), t(cond), t(sw.T.copy()), t(sb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_adaptive_model_builds_and_runs():
    """What the adaptive config changes in the model: the norms, the gates,
    a square action encoder w2, the time embedding's width; every
    parameter is drawn by init_params, and adaLN-Zero's gates start at
    sigmoid(-2) as JAX's do."""
    cfg = adaptive_cfg("adaLN-Zero")
    tm = PiZero(cfg, device="cpu", dtype=torch.float32)
    tm.init_params(torch.Generator().manual_seed(0))
    layer = tm.joint["action"].layers[0]
    assert isinstance(layer.input_norm, t_joint.AdaptiveRMSNorm)
    assert isinstance(tm.joint["action"].final_norm, t_joint.AdaptiveRMSNorm)
    assert torch.equal(layer.post_scale.gamma.bias, torch.full((16,), -2.0))
    assert not torch.count_nonzero(layer.final_scale.gamma.weight)
    assert tm.action_encoder_w2.in_features == 16
    assert tm._time_embedding(torch.zeros(2)).shape == (2, cfg.time_hidden_size)
    assert isinstance(tm.joint["vlm"].layers[0].input_norm, torch.nn.Parameter)
    _, t_in = _inputs(cfg)
    out = tm.infer_action(**t_in)
    assert out.shape == (2, 4, 7) and torch.isfinite(out).all()
    plain = PiZero(adaptive_cfg("adaLN"), device="cpu", dtype=torch.float32)
    assert plain.joint["action"].layers[0].post_scale is None


@pytest.mark.parametrize("naive", [False, True])
@pytest.mark.parametrize("mode", ["adaLN", "adaLN-Zero"])
def test_adaptive_infer_action_matches_jax(mode, naive):
    cfg, jm, params, tm = adaptive_pair(mode)
    j_in, t_in = _inputs(cfg)
    if naive:
        ref = jm.infer_action_naive(params, **j_in, num_inference_steps=3)
        out = tm.infer_action_naive(**t_in, num_inference_steps=3)
    else:
        ref = jm.infer_action(params, **j_in, num_inference_steps=3)
        out = tm.infer_action(**t_in, num_inference_steps=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_naive_prefix_is_conditioned_at_t0(monkeypatch):
    """The naive step freezes the adaptive prefix at t=0, as the cached step
    holds it: the two agree. Conditioning the prefix on each step's time
    instead (no ``prefix_time_cond``) moves the actions far past that."""
    cfg, _, _, tm = adaptive_pair("adaLN-Zero")
    _, t_in = _inputs(cfg)
    cached = tm.infer_action(**t_in, num_inference_steps=3)
    naive = tm.infer_action_naive(**t_in, num_inference_steps=3)
    torch.testing.assert_close(naive, cached, rtol=1e-4, atol=1e-5)
    real = t_joint.naive_forward

    def unfrozen(*args, prefix_time_cond=None, **kwargs):
        assert prefix_time_cond is not None
        return real(*args, **kwargs)

    monkeypatch.setattr(t_joint, "naive_forward", unfrozen)
    moved = tm.infer_action_naive(**t_in, num_inference_steps=3)
    assert (moved - cached).abs().max() > 1e-3
