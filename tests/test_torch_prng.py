"""The port's threefry random numbers (blurr_tpu_torch.ops.prng) against
jax.random on the CPU, and the served flow noise against the noise JAX
draws for the same seed and request index.

Tolerances: key data and random bits are bit-equal. A bf16 normal is drawn
from 8 random bits, so it takes one of 128 uniform values; each maps to the
same bf16 in both (bit-equal, checked over a draw that hits all 128). An
fp32 normal may sit up to 4 ulps from JAX's: the port's erf_inv is XLA's
polynomial, but its log1p is torch's, which differs from XLA's by an ulp
(ops/prng.py:erf_inv, held to 2 ulps below), and sqrt(2) * erf_inv rounds
once more.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu_torch.ops import prng
from blurr_tpu_torch.presets import apply_preset, load_config
from blurr_tpu_torch.serving.server import ActionServer

FP32_ULPS = 4
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
KEYS = [(0, 0), (42, 3), (7, 1000), (2**32 - 1, 5), (-1, 2**31 + 7)]
SHAPES = [(4,), (1, 4, 7), (3, 5), (1,), (2, 51, 7)]


def _jax_key(seed, idx):
    return jax.random.fold_in(jax.random.PRNGKey(seed), idx)


def _key(seed, idx):
    return prng.fold_in(prng.prng_key(seed), idx)


def _assert_normal_matches(got: torch.Tensor, want: np.ndarray, dtype) -> None:
    got = got.float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert (np.abs(got - want) <= FP32_ULPS * ulp).all()


@pytest.mark.parametrize("key,want", [
    (lambda: prng.prng_key(42), [0, 42]),
    (lambda: _key(42, 3), [3134548294, 894150801]),
    (lambda: _key(0, 0), [1797259609, 2579123966]),
    (lambda: prng.random_bits(_key(0, 0), (4,)), [3617712097, 783310428, 975722988, 518513098]),
])
def test_known_vectors(key, want):
    np.testing.assert_array_equal(key(), np.array(want, np.uint32))


def test_known_fp32_normal():
    got = prng.normal(_key(0, 0), (1, 4, 7), torch.float32)
    np.testing.assert_allclose(got.ravel()[:3].numpy(), [1.0040143, -0.9063372, -0.7481722],
                               rtol=1e-7)


@pytest.mark.parametrize("seed,idx", KEYS)
def test_key_data_matches_jax(seed, idx):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
    np.testing.assert_array_equal(_key(seed, idx),
                                  np.asarray(jax.random.key_data(_jax_key(seed, idx))))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bit_width,jdtype", [(8, jnp.uint8), (16, jnp.uint16),
                                              (32, jnp.uint32)])
@pytest.mark.parametrize("seed,idx", KEYS[:3])
def test_random_bits_match_jax(seed, idx, bit_width, jdtype, shape):
    got = prng.random_bits(_key(seed, idx), shape, bit_width)
    want = np.asarray(jax.random.bits(_jax_key(seed, idx), shape, jdtype))
    assert got.dtype == want.dtype and got.shape == tuple(shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,idx", KEYS)
def test_normal_matches_jax(seed, idx, dtype, shape):
    got = prng.normal(_key(seed, idx), shape, dtype)
    assert got.dtype == dtype and got.shape == tuple(shape) and got.device.type == "cpu"
    want = np.asarray(jax.random.normal(_jax_key(seed, idx), shape, JAX_DTYPE[dtype])
                      .astype(jnp.float32))
    _assert_normal_matches(got, want, dtype)


def test_bf16_normal_matches_jax_at_every_uniform():
    """4,096 draws hit all 128 uniform values a bf16 normal can take."""
    key, shape = _key(3, 11), (64, 64)
    assert len(np.unique(prng.random_bits(key, shape, 8) >> 1)) == 128
    want = np.asarray(jax.random.normal(_jax_key(3, 11), shape, jnp.bfloat16)
                      .astype(jnp.float32))
    _assert_normal_matches(prng.normal(key, shape, torch.bfloat16), want, torch.bfloat16)


def test_erf_inv_follows_xla():
    """Within 2 ulps of lax.erf_inv over (-1, 1), the tails included;
    torch.erfinv, accurate to ~1 ulp, is tens of ulps away there."""
    rng = np.random.RandomState(0)
    u = np.concatenate([rng.uniform(-1, 1, 20000), 1 - rng.uniform(0, 1e-3, 5000),
                        rng.uniform(-1e-3, 1e-3, 5000), [-1.0, 1.0]]).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    got = prng.erf_inv(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got[-2:], want[-2:])  # -inf, inf
    ulp = np.spacing(np.abs(want[:-2]))
    assert (np.abs(got[:-2] - want[:-2]) <= 2 * ulp).all()
    assert (np.abs(torch.erfinv(torch.from_numpy(u[:-2])).numpy() - want[:-2]) > 8 * ulp).any()


def test_rejects_what_jax_does_not_draw():
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(_key(0, 0), (2,), 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        prng.normal(_key(0, 0), (2,), torch.float64)
    with pytest.raises(OverflowError):
        prng.prng_key(2**32)


@pytest.mark.parametrize("preset,dtype", [("prefix_cache", torch.float32),
                                          ("blurr", torch.bfloat16)])
def test_server_noise_is_jax_noise(preset, dtype):
    """The noise each request reaches infer_action with equals
    jax.random.normal(fold_in(PRNGKey(seed), idx), (1, n_tok, act_dim),
    dtype) for the served dtype; warmup draws idx 0 and does not count."""
    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, preset)
    seed = 1234
    srv = ActionServer(cfg, "random", device="cpu", seed=seed)
    assert srv.dtype == dtype
    seen = []

    def record(ids, am, px, pr, noise):
        seen.append(noise.clone())
        return torch.zeros(1, *noise.shape[1:])

    srv.model.infer_action = record
    size = cfg["vision"]["config"]["image_size"]
    srv.warmup()
    for _ in range(3):
        srv.predict(np.zeros((size, size, 3), np.uint8), "pick", [0.0] * 7)
    shape = (1, srv.model.spec.num_action_tokens, srv.model.spec.action_dim)
    for noise, idx in zip(seen, [0, 0, 1, 2]):
        want = np.asarray(jax.random.normal(_jax_key(seed, idx), shape, JAX_DTYPE[dtype])
                          .astype(jnp.float32))
        assert noise.dtype == dtype and noise.shape == shape
        _assert_normal_matches(noise, want, dtype)
    assert not torch.equal(seen[2], seen[3])


def test_batched_eval_noise_is_jax_noise(tmp_path):
    """BatchedEvalAgent (blurr preset, bf16, 3 envs): round i's noise is one
    draw jax.random.normal(fold_in(PRNGKey(seed), i), (3, n_tok, act_dim),
    bf16), bit for bit, as JAX's batched agent draws it in-graph."""
    from blurr_tpu_torch.agent.batched_eval import BatchedEvalAgent

    cfg = load_config("config/eval/bridge_tiny.yaml")
    apply_preset(cfg, "blurr")
    cfg["env"]["task"] = "fake_widowx_carrot_on_plate"
    cfg["env"]["adapter"]["pretrained_model_path"] = "(stub)"
    cfg.update({"n_eval_episode": 3, "n_video": 0, "seed": 77, "batch_envs": 3,
                "checkpoint_path": None, "log_dir": str(tmp_path)})
    agent = BatchedEvalAgent(cfg, device="cpu")
    seen = []

    def record(ids, am, px, pr, noise):
        assert ids.shape[0] == px.shape[0] == pr.shape[0] == 3
        seen.append(noise.clone())
        return torch.zeros(noise.shape)

    agent.model.infer_action = record
    agent.run()
    shape = (3, agent.model.spec.num_action_tokens, agent.model.spec.action_dim)
    assert len(seen) == 12 // cfg["act_steps"]
    for idx, noise in enumerate(seen):
        want = np.asarray(jax.random.normal(_jax_key(77, idx), shape, jnp.bfloat16)
                          .astype(jnp.float32))
        assert noise.dtype == torch.bfloat16 and noise.shape == shape
        _assert_normal_matches(noise, want, torch.bfloat16)
