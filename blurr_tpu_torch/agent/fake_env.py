"""A dependency-free SimplerEnv stand-in emitting ManiSkill-shaped obs dicts.

The port's own copy of ``blurr_tpu/agent/fake_env.py``: the same dynamics
and the same ``RandomState`` draws, so both packages' agents see the same
observations, byte for byte. It lets the closed-loop eval stack (EvalAgent
+ adapters + collectors) run without the SimplerEnv/ManiSkill
installation, and is selected when simpler_env is unavailable or the task
starts with "fake_".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class _Spec:
    max_episode_steps: int = 12


class FakeSimplerEnv:
    """Deterministic, ACTION-COUPLED per-episode dynamics; success decided by
    a hash of the episode id so success-rate summaries are reproducible.

    The dynamics integrate the policy's delta-EEF actions (WidowX convention:
    [dxyz(3), drpy(3), gripper]) into an internal pose, and both the proprio
    vector and the camera image are pure functions of that pose. This matters
    for closed-loop experiments: a perturbation in the policy's action (e.g.
    quantization noise) feeds back through the observation stream and
    compounds across control steps, as it would in the real simulator.
    """

    def __init__(self, task: str = "fake_widowx_carrot_on_plate", image_hw=(480, 640)):
        self.task = task
        self.spec = _Spec()
        self._episode_id = 0
        self._step = 0
        self._rng = np.random.RandomState(0)
        self._image_hw = image_hw
        self._reset_state(0)

    # -- api surface used by EvalAgent -------------------------------------
    def reset(self, options=None, seed=None):
        options = options or {}
        self._episode_id = int(
            (options.get("obj_init_options") or {}).get("episode_id", 0)
        )
        self._step = 0
        self._reset_state(self._episode_id + (seed or 0))
        reset_info = {"scene_name": "fake_bridge_table", "episode_id": self._episode_id}
        return self._obs(), reset_info

    def get_language_instruction(self) -> str:
        return "put the carrot on the plate"

    def is_final_subtask(self) -> bool:
        return True

    def step(self, action):
        action = np.asarray(action, dtype=np.float64)
        assert action.shape == (7,), action.shape
        assert np.isfinite(action).all(), "non-finite action"
        # integrate delta-EEF control into the pose (position / rpy / gripper)
        self._eef_xyz = np.clip(self._eef_xyz + 0.02 * action[:3], 0.0, 0.3)
        self._eef_rpy = (self._eef_rpy + 0.05 * action[3:6] + np.pi) % (2 * np.pi) - np.pi
        self._gripper = float(np.clip(self._gripper + 0.5 * action[6], 0.0, 1.0))
        self._step += 1
        truncated = self._step >= self.spec.max_episode_steps
        success = truncated and (self._episode_id % 3 == 0)
        reward = float(success)
        return self._obs(), reward, success, truncated, {}

    # -- internals ----------------------------------------------------------
    def _reset_state(self, seed: int) -> None:
        self._rng = np.random.RandomState(seed)
        self._eef_xyz = 0.10 + 0.10 * self._rng.rand(3)
        self._eef_rpy = 0.2 * (self._rng.rand(3) - 0.5)
        self._gripper = float(self._rng.rand())
        h, w = self._image_hw
        # episode-constant background; the moving "arm" is stamped per obs
        self._background = self._rng.randint(0, 256, (h, w, 3), dtype=np.uint8)

    def _obs(self):
        from blurr_tpu_torch.utils.geometry import euler2quat

        h, w = self._image_hw
        img = self._background.copy()
        # stamp a bright square whose position/size track the EEF pose so the
        # image is a deterministic function of the integrated action history;
        # size is resolution-scaled and coordinates clamp to keep the stamp
        # fully in-frame at any image_hw (tiny test images included)
        size = max(2, int((0.3 + (self._eef_xyz[2] / 0.3)) * 0.2 * min(h, w)))
        cy = max(0, int((self._eef_xyz[1] / 0.3) * max(h - size, 1)))
        cx = max(0, int((self._eef_xyz[0] / 0.3) * max(w - size, 1)))
        shade = np.array(
            [255 * self._gripper, 255 * (1 - self._gripper), 220], dtype=np.uint8
        )
        img[cy : cy + size, cx : cx + size] = shade
        quat_wxyz = euler2quat(*self._eef_rpy)
        eef = np.concatenate([self._eef_xyz, quat_wxyz, [self._gripper]])
        return {"agent": {"eef_pos": eef}, "image": img}


def make_env(task: str):
    """simpler_env.make when available and not a fake task; FakeSimplerEnv
    otherwise."""
    if not task.startswith("fake"):
        try:
            import simpler_env

            return simpler_env.make(task)
        except ImportError:
            import logging

            logging.getLogger(__name__).warning(
                "simpler_env not installed; using FakeSimplerEnv for task %s", task
            )
        except Exception as exc:
            # installed but broken (headless containers: missing Vulkan/GL,
            # broken sapien) — degrade LOUDLY rather than crash the eval
            import logging

            logging.getLogger(__name__).warning(
                "simpler_env.make(%r) failed (%s: %s); falling back to "
                "FakeSimplerEnv — success rates are NOT real-sim results.",
                task, type(exc).__name__, exc,
            )
    return FakeSimplerEnv(task)
