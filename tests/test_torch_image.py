"""The port's Lanczos resize (blurr_tpu_torch/utils/image.py), its native
binding (blurr_tpu_torch/native.py), ``PiZero.infer_action_from_frame`` and
off-size frames through both action servers, against the JAX package on the
CPU.

Tolerances: the cv2 and native rungs give the JAX helper's bytes exactly.
The torch rung computes ``jax.image.resize(..., "lanczos5")`` in fp32 with
another ``sin`` and another summation order (its weights sit within a few
fp32 ulps of JAX's), so a value within ~1e-3 of a .5 boundary may round to
the other side: at most 1 level, at most 10 values per case (5 of 150,528 at
480x640 -> 224x224 with these seeds, 0 in the other cases). The weight
matrices: within 1e-6 (weights of at most 1; JAX's and torch's fp32
``sin`` and sums differ by an ulp here and there, 6.6e-7 at most). ``infer_action_from_frame``: the resized
pixel values within 2e-5 of JAX's (fp32, normalized), the actions within
1e-4 (fp32, the tiny model); the two servers (fp32 baseline preset) within
1e-4, as tests/test_torch_checkpoint.py holds them.
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from blurr_tpu import native as j_native
from blurr_tpu.models.pi0 import checkpoint as j_ckpt
from blurr_tpu.serving import server as j_server
from blurr_tpu.utils import image as j_image
from blurr_tpu_torch import native as t_native
from blurr_tpu_torch.models.pi0.checkpoint import load_jax_params
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.presets import apply_preset
from blurr_tpu_torch.serving.server import ActionServer
from blurr_tpu_torch.utils import image as t_image
from tests.util import tiny_inputs, tiny_pi0_cfg

REPO = t_native.SOURCE.parents[1]
# (source H, W) -> (target H, W): the fake env's 480x640 frame to the tiny
# configs' 56 and to bridge.yaml's 224, one upsample, the identity
CASES = [((480, 640), (56, 56)), ((480, 640), (224, 224)), ((40, 50), (56, 56)),
         ((56, 56), (56, 56))]
MAX_OFF_BY_ONE = 10


def _frame(hw, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3), np.uint8)


@pytest.fixture
def fresh_rung_log(monkeypatch):
    monkeypatch.setattr(t_image, "_rungs_logged", set())


@pytest.mark.parametrize("src,dst", CASES, ids=lambda c: "x".join(map(str, c)))
def test_cv2_rung_matches_jax(src, dst, fresh_rung_log, caplog):
    assert t_image.cv2 is not None and j_image.cv2 is not None
    img = _frame(src)
    with caplog.at_level(logging.INFO, logger=t_image.__name__):
        got = t_image.lanczos_resize_uint8(img, *dst)
    np.testing.assert_array_equal(got, j_image.lanczos_resize_uint8(img, *dst))
    assert got.shape == (*dst, 3) and got.dtype == np.uint8
    assert ("the cv2 rung" in caplog.text) == (src != dst)


@pytest.mark.parametrize("src,dst", CASES, ids=lambda c: "x".join(map(str, c)))
def test_native_rung_matches_jax(src, dst, monkeypatch, fresh_rung_log, caplog):
    """cv2 gone from both modules: the port's binding of
    native/preprocess.cpp against JAX's."""
    monkeypatch.setattr(t_image, "cv2", None)
    monkeypatch.setattr(j_image, "cv2", None)
    assert t_native.available() and j_native.available()
    img = _frame(src, seed=1)
    with caplog.at_level(logging.INFO, logger=t_image.__name__):
        got = t_image.lanczos_resize_uint8(img, *dst)
    np.testing.assert_array_equal(got, j_image.lanczos_resize_uint8(img, *dst))
    assert ("the native rung" in caplog.text) == (src != dst)
    chw = t_native.lanczos4_resize_normalize_chw(img, dst)
    np.testing.assert_array_equal(chw, j_native.lanczos4_resize_normalize_chw(img, dst))


@pytest.mark.parametrize("src,dst", CASES, ids=lambda c: "x".join(map(str, c)))
def test_torch_rung_matches_jax_image(src, dst, monkeypatch, fresh_rung_log, caplog):
    """cv2 and the native library gone from both: the torch rung against
    jax.image lanczos5 (at most 1 level at a .5 boundary)."""
    for mod in (t_image, j_image):
        monkeypatch.setattr(mod, "cv2", None)
    monkeypatch.setattr(t_native, "available", lambda: False)
    monkeypatch.setattr(j_native, "available", lambda: False)
    img = _frame(src, seed=2)
    with caplog.at_level(logging.INFO, logger=t_image.__name__):
        got = t_image.lanczos_resize_uint8(img, *dst)
        t_image.lanczos_resize_uint8(img, *dst)
    want = j_image.lanczos_resize_uint8(img, *dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= MAX_OFF_BY_ONE, (diff > 0).sum()
    assert caplog.text.count("the torch rung") == (src != dst)  # once per process


@pytest.mark.parametrize("radius", [3, 5])
@pytest.mark.parametrize("n_in,n_out", [(640, 224), (480, 56), (50, 56), (7, 3)])
def test_weight_matrix_matches_jax(n_in, n_out, radius):
    """jax.image.resize of the identity along one axis is its weight
    matrix (a one-hot dot at HIGHEST precision is exact)."""
    eye = jnp.eye(n_in, dtype=jnp.float32)[..., None]
    want = np.asarray(jax.image.resize(eye, (n_in, n_out, 1), f"lanczos{radius}"))[..., 0]
    got = t_image.lanczos_weights(n_in, n_out, radius)
    assert got.dtype == torch.float32 and got.shape == (n_in, n_out)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _tree(path: Path):
    return sorted((p.relative_to(path), p.stat().st_size, p.stat().st_mtime_ns)
                  for p in path.rglob("*"))


def test_native_build_writes_only_under_the_port(tmp_path, monkeypatch):
    """The port's library lies under blurr_tpu_torch/_build/native/; a
    fresh build writes nothing under native/."""
    lib = t_native.library_path()
    assert lib.parent.parent == REPO / "blurr_tpu_torch" / "_build" / "native"
    assert t_native.available() and lib.is_file()
    before = _tree(REPO / "native")
    built = t_native.build(tmp_path)
    assert built == t_native.library_path(tmp_path) and built.is_file()
    assert _tree(REPO / "native") == before
    assert t_native._bind(built).blurr_native_version() == 1


def test_native_build_failure_skips_the_rung(tmp_path, monkeypatch, caplog):
    """No compiler: available() is False, the reason logged once at
    WARNING, and the ladder falls through to the torch rung."""
    monkeypatch.setattr(t_native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(t_native._State, "lib", None)
    monkeypatch.setattr(t_native._State, "failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(t_image, "cv2", None)
    monkeypatch.setattr(t_image, "_rungs_logged", set())
    with caplog.at_level(logging.INFO):
        assert not t_native.available() and not t_native.available()
        out = t_image.lanczos_resize_uint8(_frame((30, 40)), 20, 20)
    assert out.shape == (20, 20, 3)
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "no-such-compiler" in warned[0].getMessage()
    assert "the torch rung" in caplog.text


def test_infer_action_from_frame_matches_jax():
    """As tests/test_pizero.py drives JAX's: a smooth 60x80 frame, batch 2,
    the tiny model's weights carried over."""
    from blurr_tpu.models.pi0.pizero import PiZero as JPiZero

    cfg = tiny_pi0_cfg()
    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    tm = load_jax_params(PiZero(cfg, device="cpu", dtype=torch.float32),
                         jax.tree.map(np.asarray, params))
    inputs = tiny_inputs(cfg)
    h, w = 60, 80
    yy, xx = np.meshgrid(np.linspace(0, 255, h), np.linspace(0, 255, w), indexing="ij")
    frame = np.stack([yy, xx, (yy + xx) / 2], -1).astype(np.uint8)[None]
    frame = np.ascontiguousarray(np.broadcast_to(frame, (2, h, w, 3)))
    want = np.asarray(jm.infer_action_from_frame(
        params, inputs["input_ids"], inputs["attention_mask"], jnp.asarray(frame),
        inputs["proprios"], inputs["noise"]))
    t_in = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    got = tm.infer_action_from_frame(t_in["input_ids"], t_in["attention_mask"],
                                     torch.from_numpy(frame), t_in["proprios"], t_in["noise"])
    assert got.shape == (2, 4, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    size = cfg.vision.config.image_size
    px = jax.image.resize(jnp.asarray(frame, jnp.float32), (2, size, size, 3), "lanczos3")
    px = (np.asarray(px) / 255.0 - 0.5) / 0.5
    mine = (t_image.lanczos_resize(torch.from_numpy(frame).float(), size, size, 3) / 255.0
            - 0.5) / 0.5
    np.testing.assert_allclose(mine.numpy(), px, rtol=0, atol=2e-5)


def test_both_servers_answer_an_off_size_frame(tmp_path):
    """JAX's and the port's ActionServer on one .pt (fp32, baseline preset),
    each given frames that are not image_size square."""
    cfg = tiny_pi0_cfg(vocab_size=1024, image_token_index=1000)
    from blurr_tpu.models.pi0.pizero import PiZero as JPiZero

    jm = JPiZero(cfg)
    params = jm.tie_action_proprio_weights(jm.init_params(jax.random.PRNGKey(0)))
    path = tmp_path / "pi0.pt"
    j_ckpt.save_torch_checkpoint(params, str(path))
    apply_preset(cfg, "baseline")
    cfg["num_inference_steps"] = 2
    jax_srv = j_server.ActionServer(cfg, str(path), seed=5)
    port_srv = ActionServer(cfg, str(path), device="cpu", seed=5)
    size = cfg.vision.config.image_size
    rng = np.random.RandomState(0)
    for hw in ((48, 64), (size + 4, size)):
        image = rng.randint(0, 256, (*hw, 3), np.uint8)
        proprio = rng.uniform(-1, 1, 7).tolist()
        want = jax_srv.predict(image, "put the spoon on the towel", proprio)
        got = port_srv.predict(image, "put the spoon on the towel", proprio)
        assert got.shape == (4, 7)
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="HxWx3"):
        port_srv.predict(np.zeros((size, size, 4), np.uint8), "x", [0.0] * 7)
