"""Batched closed-loop evaluation: N environments stepped in lockstep with
ONE batched control step per round.

Counterpart of ``blurr_tpu/agent/batched_eval.py:BatchedEvalAgent``. The
batch-1 step reads every weight for one inference; stepping N episodes at
once shares that traffic over N inferences, while per-episode semantics
stay those of the serial agent: per-env adapters keep their own state (EDR
sticky gripper), episodes reset independently with staggered episode_ids,
and the summary lines keep the collector contract.

Each round the slots' host inputs are preprocessed in a thread pool (cv2
and the native resize release the GIL), uploaded and concatenated on the
device, and one ``infer_action`` runs over batch N with one noise draw of
shape (N, horizon, action_dim) from ``fold_in(PRNGKey(seed), round)``, as
JAX draws it in-graph. Finished slots stay in the batch (static shapes)
with their outputs discarded until every requested episode has run.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from blurr_tpu_torch.agent.eval_agent import EvalAgent
from blurr_tpu_torch.agent.fake_env import make_env
from blurr_tpu_torch.config.core import instantiate

log = logging.getLogger(__name__)


class _Slot:
    __slots__ = ("env", "adapter", "episode", "obs", "instruction", "steps",
                 "active", "inputs")


class BatchedEvalAgent(EvalAgent):
    """EvalAgent with ``cfg['batch_envs']`` environments in lockstep."""

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.n_envs = int(cfg.get("batch_envs", 1))
        if self.n_envs < 1:
            raise ValueError(f"batch_envs must be >= 1, got {self.n_envs}")
        if self.n_video > 0:
            log.warning(
                "Video recording is not supported in batched eval; "
                "set --batch-envs 1 (serial agent) to record. Disabling."
            )
            self.n_video = 0
        if self.async_pipeline:
            log.warning(
                "--async-pipeline has no effect in batched eval (the batched "
                "step already amortizes device time over N envs); ignoring."
            )
            self.async_pipeline = False
        # slot 0 reuses the serial agent's env/adapter; the rest are fresh
        self.envs = [self.env] + [
            make_env(cfg["env"]["task"]) for _ in range(self.n_envs - 1)
        ]
        self.adapters = [self.env_adapter] + [
            instantiate(cfg["env"]["adapter"]) for _ in range(self.n_envs - 1)
        ]

    def _dispatch_batched(self, slot_inputs: list) -> torch.Tensor:
        """One lockstep control step from the N slots' host inputs (dicts of
        [1, ...] tensors), concatenated on the device; not fetched."""
        parts = [self.device_inputs(inp) for inp in slot_inputs]
        ids, am, px, pr = (torch.cat(p) for p in zip(*parts))
        out = self._infer_fn()(ids, am, px, pr, self.noise(self._step_idx, len(slot_inputs)))
        self._step_idx += 1
        return out

    def _batched_infer(self, slot_inputs: list) -> np.ndarray:
        return self._sanitize(self._dispatch_batched(slot_inputs).float().cpu().numpy())

    def run(self):
        n_target = self.n_eval_episode
        log.info(
            "BatchedEvalAgent.run start: n_eval_episode=%d, batch_envs=%d, "
            "act_steps=%d",
            n_target, self.n_envs, self.act_steps,
        )
        with ThreadPoolExecutor(max_workers=min(8, self.n_envs)) as pool:
            return self._run(pool, n_target)

    def _run(self, pool: ThreadPoolExecutor, n_target: int) -> float:
        successes = []
        infer_times = []
        env_steps_total = 0
        next_episode = 0  # next episode_id to hand to a freed slot

        slots = []
        for i in range(self.n_envs):
            s = _Slot()
            s.env, s.adapter = self.envs[i], self.adapters[i]
            s.active = next_episode < n_target
            s.episode = next_episode if s.active else -1
            if s.active:
                next_episode += 1
            # inactive-from-start slots (n_eval_episode < batch_envs) still
            # need valid inputs to keep the batch shape — reset them too,
            # their outputs are simply never consumed
            obs, reset_info = s.env.reset(
                options={"obj_init_options": {"episode_id": max(s.episode, 0)}}
            )
            s.adapter.reset()
            s.obs = obs
            s.instruction = s.env.get_language_instruction()
            s.steps = 0
            s.inputs = s.adapter.preprocess(s.env, s.obs, s.instruction)
            if s.active:
                log.info(
                    "Reset info: %s Instruction: %s Max episode length: %s",
                    reset_info, s.instruction,
                    getattr(s.env.spec, "max_episode_steps", None),
                )
            slots.append(s)

        t_run = time.time()
        while any(s.active for s in slots):
            # preprocess every active slot (inactive slots resend their last
            # inputs so the batch shape never changes)
            active = [s for s in slots if s.active]
            if len(active) > 1:
                for s, inp in zip(active, pool.map(
                    lambda s: s.adapter.preprocess(s.env, s.obs, s.instruction),
                    active,
                )):
                    s.inputs = inp
            else:
                for s in active:
                    s.inputs = s.adapter.preprocess(s.env, s.obs, s.instruction)
            t0 = time.time()
            actions = self._batched_infer(
                [s.inputs for s in slots]
            )  # [N, horizon, act_dim]
            infer_times.append(time.time() - t0)

            for i, s in enumerate(slots):
                if not s.active:
                    continue
                env_actions = s.adapter.postprocess(actions[i])
                truncated = False
                success = False
                for env_action in env_actions[: self.act_steps]:
                    s.steps += 1
                    env_steps_total += 1
                    s.obs, _, success, truncated, _ = s.env.step(env_action)
                    if truncated:
                        break
                s.instruction = s.env.get_language_instruction()
                if truncated:
                    successes.append(success)
                    log.info(
                        "Episode %d finished. success=%s, total_steps=%d",
                        s.episode, success, s.steps,
                    )
                    if next_episode < n_target:
                        s.episode = next_episode
                        next_episode += 1
                        s.obs, reset_info = s.env.reset(
                            options={
                                "obj_init_options": {"episode_id": s.episode}
                            }
                        )
                        s.adapter.reset()
                        s.instruction = s.env.get_language_instruction()
                        s.steps = 0
                        log.info(
                            "Reset info: %s Instruction: %s "
                            "Max episode length: %s",
                            reset_info, s.instruction,
                            getattr(s.env.spec, "max_episode_steps", None),
                        )
                    else:
                        s.active = False

        elapsed = time.time() - t_run
        success_rate = float(np.mean(successes)) if successes else 0.0
        # NOTE: the literal strings below are regex-matched by the result
        # collectors (collect_bridge_eval_results.py) — do not change.
        log.info("============ Evaluation Summary ============")
        log.info(f"Number of episodes: {len(successes)}")
        log.info(f"Success rate: {success_rate}")
        if len(infer_times) > 1:
            steady = sorted(infer_times[1:])
            log.info(
                "Inference wall-clock: first %.1f ms (incl. compile), "
                "steady p50 %.1f ms / mean %.1f ms over %d steps",
                infer_times[0] * 1000,
                steady[len(steady) // 2] * 1000,
                float(np.mean(steady)) * 1000,
                len(steady),
            )
        log.info(
            "Batched eval: %d envs in lockstep, %d env steps in %.1f s "
            "(%.1f env-steps/s aggregate)",
            self.n_envs, env_steps_total, elapsed,
            env_steps_total / max(elapsed, 1e-9),
        )
        log.info("============================================")
        return success_rate
