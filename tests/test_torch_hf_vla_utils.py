"""The port's OpenVLA eval helpers (``blurr_tpu_torch/agent/hf_vla_utils.py``)
against the JAX package's on seeded numpy inputs: images bit for bit
(the same PIL calls), the action and proprio maps within 1e-6, the gripper
binarization of both variants with the mask on, off and absent across
[-1, 2], and the statistics merge (including that mutating one key does not
reach the other)."""

import copy
import json

import numpy as np
import pytest
from PIL import Image

from blurr_tpu.agent import hf_vla_utils as J
from blurr_tpu_torch.agent import hf_vla_utils as T

TOL = 1e-6


def _image(seed, h, w):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8))


@pytest.mark.parametrize("hw,size", [((480, 640), 224), ((224, 224), 224), ((64, 48), 28),
                                     ((256, 320), 128)])
def test_octo_style_preprocess_bit_equal(hw, size):
    img = _image(sum(hw), *hw)
    a = np.asarray(T.octo_style_preprocess(img, resize_size=size))
    b = np.asarray(J.octo_style_preprocess(img, resize_size=size))
    assert a.shape == (size, size, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", [1.0, 0.9, 0.5, 0.25, 0.01])
def test_center_crop_bit_equal(scale):
    img = _image(3, 224, 200)
    a, b = (m.center_crop_and_resize_back(img, crop_scale=scale) for m in (T, J))
    assert a.size == img.size
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if scale == 1.0:
        assert a is img


@pytest.mark.parametrize("scale", [0.0, -0.5, 1.5])
def test_center_crop_rejects_what_jax_rejects(scale):
    img = _image(4, 16, 16)
    for m in (T, J):
        with pytest.raises(ValueError, match="crop_scale"):
            m.center_crop_and_resize_back(img, crop_scale=scale)


MASKS = {"on": {"mask": [True] * 7}, "off": {"mask": [True] * 6 + [False]},
         "absent": None, "short": {"mask": [True, False]}, "no_mask": {"q01": [0.0] * 7}}
GRIPPER_VALUES = np.concatenate([np.linspace(-1.0, 2.0, 61),
                                 [0.0, 0.5, 1.0, -1e-7, 1e-7, 0.5 + 1e-7]])


@pytest.mark.parametrize("variant", ["hf", "prismatic"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_binarize_gripper_matches_jax(mask, variant):
    stats = MASKS[mask]
    for v in GRIPPER_VALUES:
        got = T.binarize_gripper_action(float(v), stats, variant=variant)
        assert got in (-1.0, 1.0)
        assert got == J.binarize_gripper_action(float(v), stats, variant=variant), v


def test_prismatic_variant_differs_in_one_branch():
    off = MASKS["off"]
    assert T.binarize_gripper_action(0.3, off) == -1.0  # [0, 1]: the 0.5 threshold
    assert T.binarize_gripper_action(0.3, off, variant="prismatic") == 1.0  # the sign
    for mask in ("on", "absent"):
        assert T.binarize_gripper_action(0.3, MASKS[mask]) == T.binarize_gripper_action(
            0.3, MASKS[mask], variant="prismatic")


@pytest.mark.parametrize("variant", ["hf", "prismatic"])
@pytest.mark.parametrize("layout", ["flat", "row", "column"])
@pytest.mark.parametrize("mask", ["on", "off", "absent"])
def test_bridge_action_to_simpler_matches_jax(layout, mask, variant):
    rng = np.random.RandomState(7)
    for _ in range(20):
        a = rng.uniform(-np.pi, np.pi, 7).astype(np.float32)
        a[:3] *= 0.05
        a[6] = rng.uniform(-1.0, 2.0)
        x = {"flat": a, "row": a[None], "column": a[:, None]}[layout]
        got = T.bridge_action_to_simpler(x, action_stats=MASKS[mask], variant=variant)
        want = J.bridge_action_to_simpler(x, action_stats=MASKS[mask], variant=variant)
        assert got.dtype == np.float32 and got.shape == (7,)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert got[6] == want[6]


def test_bridge_action_to_simpler_rejects_other_shapes():
    for m in (T, J):
        with pytest.raises(ValueError, match="7D"):
            m.bridge_action_to_simpler(np.zeros(6, np.float32))


def _quat(rng):
    q = rng.randn(4)
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("fn", ["simpler_eef_pos_to_bridge_proprio",
                                "simpler_eef_pos_to_bridge_proprio_padded"])
def test_proprio_maps_match_jax(fn):
    rng = np.random.RandomState(11)
    for i in range(30):
        eef = np.concatenate([rng.uniform(-0.5, 0.5, 3), _quat(rng), [rng.uniform(0, 1)]])
        if i == 0:
            eef[3:7] = [1.0, 0.0, 0.0, 0.0]  # the identity
        got, want = getattr(T, fn)(eef), getattr(J, fn)(eef)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for m in (T, J):
        with pytest.raises(ValueError, match="8D"):
            getattr(m, fn)(np.zeros(7))


PROPRIO_STATS = {
    "normal": {"k": {"proprio": {"q01": [-1.0, 0.0, 0.5, -2.0], "q99": [1.0, 2.0, 0.6, 2.0]}}},
    "zero_width": {"k": {"proprio": {"q01": [0.0, 1.0, 1.0, -1.0], "q99": [1.0, 1.0, 1.0, 1.0]}}},
    "all_zero": {"k": {"proprio": {"q01": [0.0] * 4, "q99": [0.0] * 4}}},
    "all_zero_width": {"k": {"proprio": {"q01": [1.0] * 4, "q99": [1.0] * 4}}},
    "other_length": {"k": {"proprio": {"q01": [0.0] * 7, "q99": [1.0] * 7}}},
    "mismatched": {"k": {"proprio": {"q01": [0.0] * 4, "q99": [1.0] * 3}}},
    "no_proprio": {"k": {"action": {}}},
    "no_key": {"other": {"proprio": {"q01": [0.0] * 4, "q99": [1.0] * 4}}},
    "none": None,
}


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("case", sorted(PROPRIO_STATS))
def test_normalize_proprio_matches_jax(case, clip):
    p = np.random.RandomState(5).uniform(-3, 3, 4).astype(np.float32)
    stats = PROPRIO_STATS[case]
    got = T.normalize_proprio(p, norm_stats=stats, unnorm_key="k", clip=clip)
    want = J.normalize_proprio(p, norm_stats=stats, unnorm_key="k", clip=clip)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert T.normalize_proprio(p, norm_stats=stats, unnorm_key=None) is p


@pytest.mark.parametrize("content,want", [
    (None, False), ("{not json", False), (json.dumps({"_name_or_path": "x/Run_IMAGE_AUG"}), True),
    (json.dumps({"_name_or_path": "openvla/openvla-7b"}), False), (json.dumps({}), False)])
def test_infer_center_crop_default_matches_jax(tmp_path, content, want):
    if content is not None:
        (tmp_path / "config.json").write_text(content)
    assert T.infer_center_crop_default(tmp_path) is want
    assert J.infer_center_crop_default(tmp_path) is want


_ACT = {"q01": [-1.0] * 7, "q99": [1.0] * 7, "mask": [True] * 6 + [False]}
INJECTIONS = {
    "empty_dataset": ({"bridge_orig": {"action": dict(_ACT)}}, {}),
    "merge_keeps_mask": (
        {"bridge_orig": {"action": {"q01": [-0.5] * 7, "mask": [True] * 7}}},
        {"bridge_dataset": {"action": {"q01": [-1.0] * 7, "q99": [2.0] * 7,
                                       "mask": [False] * 7}}}),
    "zero_proprio_replaced": (
        {"bridge_orig": {"action": dict(_ACT), "proprio": {"q01": [0.0] * 7, "q99": [0.0] * 7}}},
        {"bridge_dataset": {"action": dict(_ACT),
                            "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}),
    "proprio_gaps_filled": (
        {"bridge_orig": {"action": dict(_ACT), "proprio": {"q01": [-2.0] * 7}}},
        {"bridge_dataset": {"action": dict(_ACT),
                            "proprio": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}),
    "bridge_dataset_present": (
        {"bridge_orig": {"action": dict(_ACT)}, "bridge_dataset": {"action": {"q01": [0.0]}}},
        {"bridge_dataset": {"action": {"q99": [3.0] * 7}}}),
    "new_keys_copied": (
        {"bridge_orig": {"action": dict(_ACT)}},
        {"fractal": {"action": dict(_ACT)}, "no_action": {"proprio": {}}, "scalar": 3}),
    "no_bridge_orig": ({"fractal": {"action": dict(_ACT)}},
                       {"bridge_dataset": {"action": dict(_ACT)}}),
}


@pytest.mark.parametrize("case", sorted(INJECTIONS))
def test_injection_matches_jax(case):
    norm, ds = INJECTIONS[case]
    got = T.inject_dataset_statistics_into_norm_stats(copy.deepcopy(norm), copy.deepcopy(ds))
    want = J.inject_dataset_statistics_into_norm_stats(copy.deepcopy(norm), copy.deepcopy(ds))
    assert got == want
    assert list(got) == list(want)


def test_injected_bridge_dataset_does_not_alias_bridge_orig():
    norm, ds = INJECTIONS["zero_proprio_replaced"]
    got = T.inject_dataset_statistics_into_norm_stats(copy.deepcopy(norm), copy.deepcopy(ds))
    assert got["bridge_dataset"] == got["bridge_orig"]
    got["bridge_dataset"]["action"]["q01"][0] = 123.0
    got["bridge_dataset"]["proprio"]["q99"][0] = 456.0
    assert got["bridge_orig"]["action"]["q01"][0] == -1.0
    assert got["bridge_orig"]["proprio"]["q99"][0] == 1.0
