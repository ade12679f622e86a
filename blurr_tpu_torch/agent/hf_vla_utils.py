"""OpenVLA(-OFT) and MiniVLA eval helpers: image preprocessing, the
action / proprio maps between Bridge and SimplerEnv, and the statistics
merge.

The port's own copy of ``blurr_tpu/agent/hf_vla_utils.py`` (numpy and PIL
on the host; no device code), so the eval CLIs import nothing of the JAX
package. ``tests/test_torch_hf_vla_utils.py`` holds every function equal
to JAX's: images bit for bit, the maps within 1e-6.

- ``octo_style_preprocess``: a JPEG q95 round trip (the RLDS artifact of
  the training data), then LANCZOS to 128, then to the model's size.
- ``center_crop_and_resize_back``: a centred crop of ``crop_scale`` of the
  area, resized back (bilinear).
- ``binarize_gripper_action``: the gripper to {-1, 1}, aware of whether the
  statistics mask normalizes it; ``variant="prismatic"`` thresholds on sign
  where the mask leaves it out.
- ``bridge_action_to_simpler``: [dx, dy, dz, roll, pitch, yaw, gripper] to
  [dx, dy, dz, rotation vector, gripper in {-1, 1}].
- ``simpler_eef_pos_to_bridge_proprio`` (and ``_padded``): SimplerEnv's
  [xyz, wxyz quaternion, gripper] to Bridge's proprio [xyz, rpy, (0,)
  gripper].
- ``normalize_proprio``: q01 / q99 bounds to [-1, 1].
- ``infer_center_crop_default``: on where the snapshot's ``config.json``
  names an image-augmented run.
- ``inject_dataset_statistics_into_norm_stats``: ``dataset_statistics.json``
  merged into ``norm_stats`` (``config.json``'s values win where both have
  one).
"""

from __future__ import annotations

import copy
import io
import json
import math
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
from PIL import Image

from blurr_tpu_torch.utils.geometry import euler2axangle, mat2euler, quat2mat


def octo_style_preprocess(image: Image.Image, *, resize_size: int,
                          base_size: int = 128) -> Image.Image:
    """JPEG q95 round trip, then LANCZOS to ``base_size``, then to
    ``resize_size``."""
    resample = Image.Resampling.LANCZOS
    buf = io.BytesIO()
    image.save(buf, format="JPEG", quality=95)
    buf.seek(0)
    image = Image.open(buf).convert("RGB")
    image = image.resize((base_size, base_size), resample=resample)
    return image.resize((resize_size, resize_size), resample=resample)


def center_crop_and_resize_back(image: Image.Image, *, crop_scale: float) -> Image.Image:
    """The centred crop holding ``crop_scale`` of the area (each side scaled
    by its square root), resized back to the input's size (bilinear)."""
    if not (0.0 < crop_scale <= 1.0):
        raise ValueError(f"crop_scale must be in (0, 1], got {crop_scale}")
    if crop_scale >= 1.0:
        return image
    w, h = image.size
    side = math.sqrt(crop_scale)
    new_w, new_h = max(1, int(round(w * side))), max(1, int(round(h * side)))
    left, top = max(0, (w - new_w) // 2), max(0, (h - new_h) // 2)
    cropped = image.crop((left, top, left + new_w, top + new_h))
    return cropped.resize((w, h), resample=Image.Resampling.BILINEAR)


def _threshold(value: float) -> float:
    """0.5 inside [0, 1] (an open/close probability), else the sign."""
    if 0.0 <= value <= 1.0:
        return -1.0 if value <= 0.5 else 1.0
    return -1.0 if value <= 0.0 else 1.0


def binarize_gripper_action(value: float, action_stats: Optional[Dict[str, Any]] = None, *,
                            variant: str = "hf") -> float:
    """The gripper value to -1 (close) or 1 (open). A 7-long ``mask`` in
    ``action_stats`` that normalizes the gripper gives sign(2v - 1) (0 ->
    -1); one that leaves it out gives ``_threshold`` ("hf") or the sign
    ("prismatic"); no mask gives ``_threshold``."""
    mask = action_stats.get("mask") if action_stats else None
    if isinstance(mask, (list, tuple)) and len(mask) >= 7:
        if not bool(mask[6]):
            if variant == "prismatic":
                return -1.0 if value <= 0.0 else 1.0
            return _threshold(value)
        sign = float(np.sign(2.0 * value - 1.0))
        return -1.0 if sign == 0.0 else sign
    return _threshold(value)


def bridge_action_to_simpler(action: np.ndarray, *, action_stats: Optional[Dict[str, Any]] = None,
                             variant: str = "hf") -> np.ndarray:
    """A Bridge action (7, [1, 7] or [7, 1]) -> SimplerEnv's float32 [7]:
    the translation, the Euler angles as a rotation vector, the gripper
    binarized."""
    a = np.asarray(action, dtype=np.float32)
    if a.ndim == 2 and a.shape[1] == 7:
        a = a[0]
    elif a.ndim == 2 and a.shape[0] == 7:
        a = a[:, 0]
    a = a.reshape(-1)
    if a.shape[0] != 7:
        raise ValueError(f"Expected 7D action, got shape {a.shape}")
    axis, angle = euler2axangle(float(a[3]), float(a[4]), float(a[5]))
    out = np.zeros((7,), np.float32)
    out[:3] = a[:3]
    out[3:6] = np.asarray(axis, np.float32) * float(angle)
    out[6] = binarize_gripper_action(float(a[6]), action_stats, variant=variant)
    return out


def simpler_eef_pos_to_bridge_proprio(eef_pos: np.ndarray) -> np.ndarray:
    """8D [xyz, wxyz quaternion, gripper] -> 7D [xyz, rpy, gripper]."""
    eef_pos = np.asarray(eef_pos, np.float32).reshape(-1)
    if eef_pos.shape[0] != 8:
        raise ValueError(f"Expected 8D eef_pos, got shape {eef_pos.shape}")
    roll, pitch, yaw = mat2euler(quat2mat(eef_pos[3:7]))
    return np.asarray([eef_pos[0], eef_pos[1], eef_pos[2], roll, pitch, yaw, eef_pos[7]],
                      np.float32)


def simpler_eef_pos_to_bridge_proprio_padded(eef_pos: np.ndarray) -> np.ndarray:
    """8D [xyz, rpy, 0, gripper] (the POS_EULER layout with its pad)."""
    base = simpler_eef_pos_to_bridge_proprio(eef_pos)
    return np.concatenate([base[:6], np.asarray([0.0], np.float32), base[6:7]]).astype(np.float32)


def normalize_proprio(proprio: np.ndarray, *, norm_stats: Optional[Dict[str, Any]],
                      unnorm_key: Optional[str], clip: bool = True) -> np.ndarray:
    """``proprio`` mapped by its q01 / q99 bounds into [-1, 1] (clipped).
    Returned as it is where the statistics are missing, of another length
    or all zero; a zero-width bound divides by 1."""
    if norm_stats is None or unnorm_key is None:
        return proprio
    proprio_stats = (norm_stats.get(unnorm_key) or {}).get("proprio")
    if not isinstance(proprio_stats, dict):
        return proprio
    low = np.asarray(proprio_stats.get("q01", []), np.float32)
    high = np.asarray(proprio_stats.get("q99", []), np.float32)
    if low.size == 0 or high.size == 0 or low.shape != high.shape:
        return proprio
    if low.shape[0] != proprio.shape[0]:
        return proprio
    if np.allclose(low, 0.0) and np.allclose(high, 0.0):
        return proprio
    eps = 1e-8
    denom = (high - low).astype(np.float32)
    if np.all(np.abs(denom) < eps):
        return proprio
    denom = np.where(np.abs(denom) < eps, 1.0, denom)
    out = (2.0 * (proprio.astype(np.float32) - low) / denom) - 1.0
    if clip:
        out = np.clip(out, -1.0, 1.0)
    return out.astype(np.float32)


def infer_center_crop_default(model_path) -> bool:
    """Whether the snapshot's ``config.json`` names an image-augmented run
    ('image_aug' in ``_name_or_path``); a missing or unreadable file gives
    False."""
    cfg_path = Path(model_path) / "config.json"
    if not cfg_path.is_file():
        return False
    try:
        raw = json.loads(cfg_path.read_text())
    except Exception:
        return False
    return "image_aug" in str(raw.get("_name_or_path", "")).lower()


def _all_zeros(stats) -> bool:
    if not isinstance(stats, dict):
        return True
    for field in ("min", "max", "mean", "std", "q01", "q99"):
        vals = stats.get(field)
        if isinstance(vals, (list, tuple)) and any(float(x) != 0.0 for x in vals):
            return False
    return True


def inject_dataset_statistics_into_norm_stats(norm_stats: Dict[str, Any],
                                              dataset_stats: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``dataset_stats`` into ``norm_stats`` in place (and return it).
    ``bridge_dataset``'s action statistics fill the gaps of ``bridge_orig``'s
    (whose values and mask win), its proprio replaces an all-zero block or
    fills the gaps of one, and ``bridge_dataset`` becomes a deep copy of the
    merged ``bridge_orig`` where absent (a later change to one does not
    reach the other). Keys with an ``action`` block that ``norm_stats``
    lacks are copied over."""
    if not dataset_stats:
        return norm_stats
    if "bridge_dataset" in dataset_stats and "bridge_orig" in norm_stats:
        ds = dataset_stats["bridge_dataset"]
        base = norm_stats["bridge_orig"]
        if isinstance(ds, dict) and isinstance(base, dict):
            if isinstance(ds.get("action"), dict) and isinstance(base.get("action"), dict):
                merged = dict(ds["action"])
                merged.update(base["action"])  # keep the mask
                base["action"] = merged
            if isinstance(ds.get("proprio"), dict) and _all_zeros(base.get("proprio")):
                base["proprio"] = ds["proprio"]
            elif isinstance(ds.get("proprio"), dict) and isinstance(base.get("proprio"), dict):
                for k, v in ds["proprio"].items():
                    base["proprio"].setdefault(k, v)
            if "bridge_dataset" not in norm_stats:
                norm_stats["bridge_dataset"] = copy.deepcopy(base)
    for key, value in dataset_stats.items():
        if key in norm_stats or not isinstance(value, dict) or "action" not in value:
            continue
        norm_stats[key] = value
    return norm_stats
