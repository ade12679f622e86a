"""Raw robot example -> model-ready Pi-0 training batch (host side).

Counterpart of ``blurr_tpu/data/transform.py``. Mirrors the deployment-time
preprocessing EXACTLY, so a policy trains on the same distribution it is
served on, and the pixels are the JAX package's bit for bit:

- image: the adapters' resize ladder (cv2 LANCZOS4 > native C++ Lanczos-4 >
  torch lanczos5; the port's ``utils/image.py``) to the model's input size, then the
  VLAProcessor rescale+normalize ``(x/255 - 0.5) / 0.5`` (reference
  src/model/vla/processing.py:48-60) — computed in numpy here to keep the
  loader thread off the device.
- proprio: full-dim p01/p99 bound normalization, matching
  ``SimplerAdapter.preprocess`` (reference src/agent/env_adapter/simpler.py:
  52-98).
- action: the exact INVERSE of ``SimplerAdapter.postprocess`` (reference
  simpler.py:100-141): non-gripper dims bound-normalized with p01/p99, the
  gripper dim passed through (the adapters never denormalize it — they
  binarize the model's raw output), everything clipped to [-1, 1].

Pre-tokenized ``input_ids`` / ``attention_mask`` pass through unchanged
(instructions are episode-constant; tokenize at dataset-write time). Batches
already holding model-ready keys pass through untouched, so one loader serves
both raw and preprocessed datasets.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np

from blurr_tpu_torch.agent.env_adapter.base import bound_normalize, gaussian_normalize

Batch = Dict[str, np.ndarray]

#: raw-key -> model-ready-key handled by this transform
RAW_KEYS = {"image": "pixel_values", "proprio": "proprios", "action": "actions"}


def _load_stats(statistics) -> dict:
    if isinstance(statistics, dict):
        return statistics
    with open(statistics) as f:
        return json.load(f)


class Pi0TrainTransform:
    """See module docstring. ``statistics`` is a dataset-statistics dict or
    a path to one (``bridge_statistics.json`` schema); ``image_size`` is
    (H, W) of the model input."""

    def __init__(self, statistics, image_size: Tuple[int, int] = (224, 224),
                 action_normalization_type: str = "bound",
                 proprio_normalization_type: str = "bound",
                 cond_steps: int = 1):
        from blurr_tpu_torch.agent.env_adapter.base import hoist_field_stats

        # the adapters' own hoisting helper: train and serve normalization
        # read the statistics identically by construction
        self._stats = hoist_field_stats(_load_stats(statistics))
        self.image_size = (int(image_size[0]), int(image_size[1]))
        assert action_normalization_type in ("bound", "gaussian")
        assert proprio_normalization_type in ("bound", "gaussian")
        self.action_normalization_type = action_normalization_type
        self.proprio_normalization_type = proprio_normalization_type
        self.cond_steps = int(cond_steps)

    # -- per-field ---------------------------------------------------------

    def pixels(self, images: np.ndarray) -> np.ndarray:
        """uint8 [B, H, W, 3] (any H/W) -> float32 [B, 3, h, w] in [-1, 1]."""
        from blurr_tpu_torch.utils.image import lanczos_resize_uint8

        h, w = self.image_size
        out = np.empty((images.shape[0], 3, h, w), np.float32)
        for i, img in enumerate(images):
            resized = lanczos_resize_uint8(np.asarray(img, np.uint8), h, w)
            # VLAProcessor.process_images semantics, same op order so the
            # result is bit-identical: x/255 -> (x - 0.5) / 0.5
            out[i] = (
                resized.transpose(2, 0, 1).astype(np.float32) / 255.0 - 0.5
            ) / 0.5
        return out

    def proprios(self, proprio: np.ndarray) -> np.ndarray:
        """raw [B, Dp] or [B, T, Dp] -> normalized float32 [B, T, Dp]."""
        proprio = np.asarray(proprio, np.float64)
        if proprio.ndim == 2:
            proprio = np.repeat(proprio[:, None], self.cond_steps, axis=1)
        s = self._stats["proprio"]
        if self.proprio_normalization_type == "bound":
            norm = bound_normalize(proprio, s["p01"], s["p99"])
        else:
            norm = gaussian_normalize(proprio, s["mean"], s["std"])
        return norm.astype(np.float32)

    def actions(self, action: np.ndarray) -> np.ndarray:
        """raw [B, horizon, Da] -> normalized float32, gripper dim passed
        through; everything clipped to [-1, 1] (inverse of the adapters'
        postprocess)."""
        action = np.asarray(action, np.float64)
        s = self._stats["action"]
        if self.action_normalization_type == "bound":
            body = bound_normalize(action[..., :-1], s["p01"][:-1],
                                   s["p99"][:-1])
        else:
            body = gaussian_normalize(action[..., :-1], s["mean"][:-1],
                                      s["std"][:-1])
        gripper = np.clip(action[..., -1:], -1.0, 1.0)
        return np.concatenate([body, gripper], axis=-1).astype(np.float32)

    # -- batch ---------------------------------------------------------------

    def __call__(self, batch: Batch) -> Batch:
        out = dict(batch)
        if "image" in out:
            out["pixel_values"] = self.pixels(out.pop("image"))
        if "proprio" in out:
            out["proprios"] = self.proprios(out.pop("proprio"))
        if "action" in out:
            out["actions"] = self.actions(out.pop("action"))
        return out


def transform_for_config(cfg: dict, statistics=None,
                         dataset_statistics: Optional[dict] = None
                         ) -> Pi0TrainTransform:
    """Build the transform from an eval/train YAML config dict (bridge.yaml
    schema): image size + cond_steps + normalization types come from the
    config, statistics from the dataset manifest when present, else from the
    config's adapter ``dataset_statistics_path``."""
    stats = dataset_statistics if dataset_statistics is not None else statistics
    if stats is None:
        from blurr_tpu_torch.agent.env_adapter.simpler import _resolve_stats_path

        stats = _resolve_stats_path(
            cfg["env"]["adapter"]["dataset_statistics_path"]
        )
    adapter_cfg = cfg.get("env", {}).get("adapter", {})
    img = cfg["vision"]["config"]["image_size"]
    return Pi0TrainTransform(
        stats,
        image_size=(img, img) if np.isscalar(img) else tuple(img),
        action_normalization_type=adapter_cfg.get(
            "action_normalization_type", "bound"
        ),
        proprio_normalization_type=adapter_cfg.get(
            "proprio_normalization_type", "bound"
        ),
        cond_steps=cfg.get("cond_steps", 1),
    )
