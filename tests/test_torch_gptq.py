"""The port's GPTQ (``blurr_tpu_torch/ops/gptq.py``) against JAX's
(``blurr_tpu/ops/gptq.py``) on the CPU.

With H = I nothing is fed back: the bytes equal the port's data-free
``quantize_weight_w4a8`` and JAX's GPTQ (by the rule of
``tests/test_torch_quant.py:_check_w4a8_layer``: JAX's jitted scale is
``amax * fp32(1/7)`` where the port divides, one ulp apart in some cells).

With a correlated H the walk carries each rounding forward, so a one-ulp
difference in a scale can move later levels: the test holds three readings
against bounds set between the sound port and two planted faults (feedback
off, and U taken from H instead of H^-1; the lower factor in place of the
upper reads exactly as feedback off, since the walk reads only U's upper
triangle). Readings over seeds 1-4 of the sound port: scales within
2.4e-3 of JAX's largest, 5.6e-4 of the levels apart, ``layer_output_mse``
on held-out inputs within 1.8e-2 of JAX's; feedback off reads 0.13, 5.4e-2
and 31; the bounds are ``SCALE_REL_TOL``, ``LEVEL_FRAC_TOL`` and
``MSE_REL_TOL``. Every fault must read above each bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blurr_tpu.ops import gptq as j_gptq
from blurr_tpu_torch.ops import gptq as t_gptq
from blurr_tpu_torch.ops import int4_matmul as t_int4
from blurr_tpu_torch.ops import quant as tq

SCALE_REL_TOL = 1e-2
LEVEL_FRAC_TOL = 5e-3
MSE_REL_TOL = 0.1
K, N, GS = 256, 192, 128


def _correlated_inputs(rng, t, k, rank=8, basis=None):
    """Low-rank activations plus a little noise (JAX's test draw); a given
    ``basis`` draws a held-out batch of the same distribution."""
    if basis is None:
        basis = rng.randn(rank, k).astype(np.float32)
    coef = rng.randn(t, rank).astype(np.float32)
    return coef @ basis + 0.05 * rng.randn(t, k).astype(np.float32), basis


def _levels(wq):
    q4 = torch.as_tensor(np.asarray(wq["q4"]))
    return t_int4.unpack_int4_reference(t_int4.from_block_major(q4))


def _readings(mine, theirs, w, x):
    s_t, s_j = mine["s"].numpy(), np.asarray(theirs["s"])
    mse_t = float(t_gptq.layer_output_mse(torch.from_numpy(x), torch.from_numpy(w), mine))
    mse_j = float(j_gptq.layer_output_mse(jnp.asarray(x), jnp.asarray(w), theirs))
    return (float(np.abs(s_t - s_j).max() / np.abs(s_j).max()),
            float((_levels(mine) != _levels(theirs)).float().mean()),
            abs(mse_t - mse_j) / mse_j)


def _within(r):
    return r[0] < SCALE_REL_TOL and r[1] < LEVEL_FRAC_TOL and r[2] < MSE_REL_TOL


def _beyond(r):
    return r[0] > SCALE_REL_TOL and r[1] > LEVEL_FRAC_TOL and r[2] > MSE_REL_TOL


def test_identity_hessian_is_the_data_free_path():
    from tests.test_torch_quant import _check_w4a8_layer

    w = np.random.RandomState(0).randn(K, N).astype(np.float32)
    got = t_gptq.gptq_quantize_weight(torch.from_numpy(w), torch.eye(K), GS)
    want = tq.quantize_weight_w4a8(torch.from_numpy(w), GS)
    assert torch.equal(got["q4"], want["q4"]) and torch.equal(got["s"], want["s"])
    theirs = j_gptq.gptq_quantize_weight(jnp.asarray(w), jnp.eye(K, dtype=jnp.float32), GS)
    _check_w4a8_layer(w, {"q4": np.asarray(theirs["q4"]), "s": np.asarray(theirs["s"])},
                      tq.W4A8Linear(**got))


@pytest.mark.parametrize("seed", [1, 2])
def test_correlated_hessian_matches_jax(seed, monkeypatch):
    rng = np.random.RandomState(seed)
    w = (0.1 * rng.randn(K, N)).astype(np.float32)
    x_cal, basis = _correlated_inputs(rng, 512, K)
    x_test, _ = _correlated_inputs(rng, 512, K, basis=basis)
    h_j = j_gptq.hessian_from_inputs(jnp.asarray(x_cal))
    h_t = t_gptq.hessian_from_inputs(torch.from_numpy(x_cal))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(h_j)).max()))
    theirs = j_gptq.gptq_quantize_weight(jnp.asarray(w), h_j, GS)
    sound = _readings(t_gptq.gptq_quantize_weight(torch.from_numpy(w), h_t, GS), theirs, w,
                      x_test)
    real = t_gptq._upper_factor
    faults = {
        "feedback off": lambda h: torch.diag_embed(real(h).diagonal(dim1=-2, dim2=-1)),
        "U of H": lambda h: torch.linalg.cholesky(h, upper=True),
    }
    read = {}
    for name, fault in faults.items():
        monkeypatch.setattr(t_gptq, "_upper_factor", fault)
        read[name] = _readings(t_gptq.gptq_quantize_weight(torch.from_numpy(w), h_t, GS),
                               theirs, w, x_test)
    monkeypatch.undo()
    print(f"seed {seed}: (scale, level fraction, output mse) sound {sound}, faults {read}")
    assert _within(sound)
    assert all(_beyond(r) for r in read.values())


def test_dead_inputs_quantize_without_feedback():
    rng = np.random.RandomState(3)
    x = _correlated_inputs(rng, 64, 128)[0]
    x[:, 7] = 0.0
    h = t_gptq.hessian_from_inputs(torch.from_numpy(x))
    assert float(h[7, 7]) > 1.0 and float(h[7].abs().sum() - h[7, 7]) == 0.0
    np.testing.assert_allclose(h.numpy(), np.asarray(j_gptq.hessian_from_inputs(jnp.asarray(x))),
                               rtol=0, atol=1e-6 * float(h.abs().max()))
    w = rng.randn(128, 64).astype(np.float32)
    q = t_gptq.gptq_quantize_weight(torch.from_numpy(w), h, 128)
    deq = tq._w4a8_deq(q["q4"], q["s"], 128)
    assert torch.isfinite(q["s"]).all() and torch.isfinite(deq).all()


def test_gptq_beats_rtn_and_feeds_w4a8():
    rng = np.random.RandomState(1)
    w = (0.1 * rng.randn(K, N)).astype(np.float32)
    x_cal, basis = _correlated_inputs(rng, 512, K)
    x_test, _ = _correlated_inputs(rng, 512, K, basis=basis)
    tw = torch.from_numpy(w)
    q_gptq = t_gptq.gptq_quantize_weight(tw, t_gptq.hessian_from_inputs(torch.from_numpy(x_cal)),
                                         GS)
    q_rtn = tq.quantize_weight_w4a8(tw, GS)
    errs = [(float(t_gptq.layer_output_mse(torch.from_numpy(x), tw, q_gptq)),
             float(t_gptq.layer_output_mse(torch.from_numpy(x), tw, q_rtn)))
            for x in (x_cal, x_test)]
    assert all(g < r for g, r in errs) and errs[0][0] < 0.8 * errs[0][1]
    # the GPTQ dict served by W4A8Linear (the int4 kernel's plain version here)
    x = torch.from_numpy(rng.randn(4, K).astype(np.float32))
    y = tq.W4A8Linear(**q_gptq)(x)
    xs = x.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127.0
    xq = torch.round(x / xs).clamp(-128, 127)
    torch.testing.assert_close(y, (xq @ tq._w4a8_deq(q_gptq["q4"], q_gptq["s"], K)) * xs,
                               rtol=1e-5, atol=1e-5)


def test_batched_walk_is_per_weight():
    """A leading axis of weights (layers, or weights sharing one input
    concatenated along N) walks each as it would walk alone."""
    rng = np.random.RandomState(4)
    ws = torch.from_numpy((0.1 * rng.randn(2, 128, 96)).astype(np.float32))
    hs = t_gptq.hessian_from_inputs(
        torch.from_numpy(np.stack([_correlated_inputs(rng, 64, 128)[0] for _ in range(2)])))
    q, s = t_gptq._gptq_levels(ws, hs, 64)
    for i in range(2):
        qi, si = t_gptq._gptq_levels(ws[i], hs[i], 64)
        torch.testing.assert_close(s[i], si, rtol=1e-6, atol=0)
        assert (q[i] != qi).float().mean() < LEVEL_FRAC_TOL
