"""SimplerEnv (ManiSkill2) adapters for Bridge/WidowX and Fractal/EDR robots.

Counterpart of ``blurr_tpu/agent/env_adapter/simpler.py``, with the same
behaviour: the Lanczos resize ladder (``utils/image.py``), p01/p99 bound
normalization from dataset statistics, euler -> axis-angle action
conversion, the Bridge top-down rotation-frame fix, the EDR sticky gripper.
Each adapter is registered in the port's registry under the JAX package's
key, so the bundled YAMLs' ``_target_`` resolves to it. ``preprocess``
returns host tensors (int64 ids, int32 mask, fp32 pixel values, fp32
proprio [1, 1, dim]); the agent moves them to its device.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

from blurr_tpu_torch.agent.env_adapter.base import BaseEnvAdapter, hoist_field_stats
from blurr_tpu_torch.config.core import register
from blurr_tpu_torch.models.pi0.processing import StubTokenizer, VLAProcessor, process_images
from blurr_tpu_torch.paths import config_root
from blurr_tpu_torch.utils.geometry import euler2axangle, mat2euler, quat2mat
from blurr_tpu_torch.utils.image import lanczos_resize_uint8

log = logging.getLogger(__name__)


def get_image_from_obs(env, obs: dict) -> np.ndarray:
    """RGB frame from a ManiSkill2 obs dict (SimplerEnv layout), or a plain
    {'image': HxWx3} dict from the fake env."""
    # the fake env's layout first: it must work whether or not simpler_env
    # is installed (simpler_env's helper would dereference robot_uid/camera
    # dicts the fake env does not have)
    if isinstance(obs.get("image"), np.ndarray):
        return obs["image"]
    try:
        from simpler_env.utils.env.observation_utils import (
            get_image_from_maniskill2_obs_dict,
        )

        return get_image_from_maniskill2_obs_dict(env, obs)
    except ImportError:
        # ManiSkill2-shaped dict without simpler_env installed
        cams = obs["image"]
        cam = next(iter(cams.values()))
        return cam["rgb"] if "rgb" in cam else cam["Color"][..., :3]


def _resolve_stats_path(path: str) -> Path:
    p = Path(path)
    if p.exists():
        return p
    alt = config_root().parent / path  # "config/bridge_statistics.json" relative
    if alt.exists():
        return alt
    raise FileNotFoundError(path)


def _load_tokenizer(pretrained_model_path: str):
    """The tokenizer at the local ``pretrained_model_path`` (never
    downloaded), else the stub with the JAX package's warning."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            pretrained_model_path, padding_side="right", local_files_only=True
        )
    except Exception as exc:  # no transformers, no files: the stub, as JAX does
        log.warning(
            "Tokenizer load failed for %r (%s); using the hash-based stub "
            "tokenizer — FINE for smoke/latency runs, MEANINGLESS for real "
            "checkpoints.", pretrained_model_path, exc,
        )
        return StubTokenizer()


class SimplerAdapter(BaseEnvAdapter):
    def __init__(
        self,
        dataset_statistics_path: str,
        pretrained_model_path: str,
        tokenizer_padding: str,
        num_image_tokens: int,
        image_size: Tuple[int, int],
        max_seq_len: int,
        action_normalization_type: str = "bound",
        proprio_normalization_type: str = "bound",
    ):
        super().__init__()
        self.image_size = tuple(image_size)
        self.action_normalization_type = action_normalization_type
        self.proprio_normalization_type = proprio_normalization_type
        if action_normalization_type not in ("bound", "gaussian"):
            raise ValueError(f"action_normalization_type {action_normalization_type!r}")
        if proprio_normalization_type not in ("bound", "gaussian"):
            raise ValueError(f"proprio_normalization_type {proprio_normalization_type!r}")

        with open(_resolve_stats_path(dataset_statistics_path)) as f:
            self.dataset_statistics = json.load(f)
        # the per-control-step arrays, hoisted out of the loop
        self._stats = hoist_field_stats(self.dataset_statistics)

        self.tokenizer = _load_tokenizer(pretrained_model_path)
        self.processor = VLAProcessor(
            self.tokenizer,
            num_image_tokens=num_image_tokens,
            max_seq_len=max_seq_len,
            tokenizer_padding=tokenizer_padding,
        )
        self._tok_cache = None

    def reset(self):
        pass

    def _resize(self, image: np.ndarray) -> np.ndarray:
        # image_size is stored in cv2 (W, H) order
        return lanczos_resize_uint8(image, self.image_size[1], self.image_size[0])

    def preprocess(self, env, obs: dict, instruction: str) -> dict:
        """sxyz Euler convention throughout."""
        image = self._resize(get_image_from_obs(env, obs))
        images = np.asarray(image, np.uint8).transpose(2, 0, 1)[None]  # [1,3,H,W]
        # the instruction is episode-constant: tokenize once, reuse the ids
        cached = self._tok_cache
        if cached is not None and cached[0] == instruction:
            model_inputs = {
                "pixel_values": process_images(torch.from_numpy(images)),
                "input_ids": cached[1],
                "attention_mask": cached[2],
            }
        else:
            model_inputs = self.processor(text=[instruction], images=images)
            self._tok_cache = (
                instruction,
                model_inputs["input_ids"],
                model_inputs["attention_mask"],
            )

        raw_proprio = self.preprocess_proprio(obs)
        if self.proprio_normalization_type == "bound":
            proprio = self.normalize_bound(
                raw_proprio,
                self._stats["proprio"]["p01"],
                self._stats["proprio"]["p99"],
                clip_min=-1,
                clip_max=1,
            )
        else:
            proprio = self.normalize_gaussian(
                raw_proprio,
                self._stats["proprio"]["mean"],
                self._stats["proprio"]["std"],
            )

        return {
            "input_ids": model_inputs["input_ids"],
            "pixel_values": model_inputs["pixel_values"],
            "attention_mask": model_inputs["attention_mask"],
            # [B, T, dim]
            "proprios": torch.from_numpy(np.asarray(proprio, np.float32)[None, None]),
        }

    def postprocess(self, actions: np.ndarray) -> List[np.ndarray]:
        """Denormalize (gripper excluded), euler->axangle, binarize gripper."""
        if self.action_normalization_type == "bound":
            raw_except_gripper = self.denormalize_bound(
                actions[:, :-1],
                self._stats["action"]["p01"][:-1],
                self._stats["action"]["p99"][:-1],
                clip_min=-1,
                clip_max=1,
            )
        else:
            raw_except_gripper = self.denormalize_gaussian(
                actions[:, :-1],
                self._stats["action"]["mean"][:-1],
                self._stats["action"]["std"][:-1],
            )
        raw_actions = np.concatenate([raw_except_gripper, actions[:, -1:]], axis=1)

        out = np.zeros((len(raw_actions), 7))
        for idx, raw in enumerate(raw_actions):
            roll, pitch, yaw = raw[3:6]
            ax, angle = euler2axangle(roll, pitch, yaw)
            gripper = self.postprocess_gripper(raw[-1])
            out[idx] = np.concatenate([raw[:3], ax * angle, [gripper]])
        return out

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        raise NotImplementedError

    def postprocess_gripper(self, action: float) -> float:
        raise NotImplementedError

    def get_video_frame(self, env, obs: dict) -> np.ndarray:
        return get_image_from_obs(env, obs)


@register("BridgeSimplerAdapter")
class BridgeSimplerAdapter(SimplerAdapter):
    """WidowX/Bridge: EE pose relative to a top-down frame, [0,1] gripper
    trained openness binarized to {-1, 1}."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        # Bridge EE pose is relative to a top-down pose, not the robot base
        self.default_rot = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        proprio = obs["agent"]["eef_pos"]
        rm_bridge = quat2mat(proprio[3:7])
        rpy = mat2euler(rm_bridge @ self.default_rot.T)
        return np.concatenate([proprio[:3], rpy, [proprio[7]]])

    def postprocess_gripper(self, action: float) -> float:
        # trained with [0,1] (1=open); Simpler expects -1 close / 1 open
        return 2.0 * (action > 0.5) - 1.0


@register("EDRSimplerAdapter")
class EDRSimplerAdapter(SimplerAdapter):
    """Google-robot/Fractal: xyzw quat proprio + sticky-gripper state machine
    (Octo-style, 15-repeat)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.sticky_gripper_num_repeat = 15
        self.reset()

    def reset(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        super().reset()

    def preprocess_proprio(self, obs: dict) -> np.ndarray:
        # simpler gives wxyz; fractal data uses xyzw
        quat_xyzw = np.roll(obs["agent"]["eef_pos"][3:7], -1)
        gripper_closedness = 1 - obs["agent"]["eef_pos"][7]
        return np.concatenate(
            [obs["agent"]["eef_pos"][:3], quat_xyzw, [gripper_closedness]]
        )

    def postprocess_gripper(self, action: float) -> float:
        action = (action * 2) - 1  # [0,1] -> [-1,1], -1 close / 1 open
        relative = -action
        if np.abs(relative) > 0.5 and not self.sticky_action_is_on:
            self.sticky_action_is_on = True
            self.sticky_gripper_action = relative
        if self.sticky_action_is_on:
            self.gripper_action_repeat += 1
            relative = self.sticky_gripper_action
        if self.gripper_action_repeat == self.sticky_gripper_num_repeat:
            self.sticky_action_is_on = False
            self.gripper_action_repeat = 0
            self.sticky_gripper_action = 0.0
        return relative
