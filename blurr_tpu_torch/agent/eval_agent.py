"""Closed-loop SimplerEnv evaluation agent of the port.

Counterpart of ``blurr_tpu/agent/eval_agent.py:EvalAgent``: the same
episode loop, async pipeline, video writer and summary lines (the result
collectors regex "Number of episodes:" and "Success rate:"). What differs
is how the step runs:

- The device is an explicit argument: ``cuda:{gpu_id}`` unless the caller
  passes another (the tests pass ``cpu``). The dtype follows ``use_bf16`` /
  ``use_fp16`` (fp16 maps to bf16, as in JAX).
- ``--checkpoint random`` draws the weights from a ``torch.Generator``
  seeded with 0, as JAX draws from ``PRNGKey(0)`` whatever the run's seed;
  a path loads a reference ``.pt`` (``models/pi0/checkpoint.py``). The
  proprio mixture is the action mixture's module, so the JAX tie holds by
  construction.
- The flow noise of dispatch ``i`` is JAX's
  ``normal(fold_in(PRNGKey(seed), i), (B, horizon, action_dim), dtype)``
  (``ops/prng.py``), as ``make_noise_infer`` draws it in-graph.
- ``_dispatch`` uploads the host inputs (from pinned memory, without
  waiting, on a card) and launches ``PiZero.infer_action`` (or
  ``infer_action_naive`` without the prefix cache) eagerly; it returns the
  device tensor without synchronizing. ``_fetch`` copies it to the host,
  which waits for the device. No operation of the step waits for the
  device (``chip_smoke.py`` holds a dispatch to that under
  ``torch.cuda.set_sync_debug_mode``), so with ``async_pipeline`` the card
  computes the next chunk while the env steps.
- ``use_torch_compile`` is read and has no effect: the step runs eagerly.
- ``--record-dataset`` needs the JAX package's dataset writer
  (``blurr_tpu.data``, ROADMAP M13) and raises.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

import blurr_tpu_torch.agent.env_adapter.simpler  # noqa: F401  (registers adapters)
from blurr_tpu_torch.agent.fake_env import make_env
from blurr_tpu_torch.config.core import instantiate
from blurr_tpu_torch.models.pi0.checkpoint import load_checkpoint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import prng
from blurr_tpu_torch.utils.monitor import log_allocated_device_memory, log_execution_time

try:
    import imageio
except Exception:  # pragma: no cover - no imageio on the machine
    imageio = None

log = logging.getLogger(__name__)

_INPUT_KEYS = ("input_ids", "attention_mask", "pixel_values", "proprios")


class EvalAgent:
    def __init__(self, cfg, device=None):
        log.info("EvalAgent.__init__ start, task=%s", cfg["env"].get("task"))
        self.cfg = cfg
        self.n_eval_episode = cfg["n_eval_episode"]
        self.n_video = cfg["n_video"]
        self.log_dir = cfg["log_dir"]
        self.video_dir = os.path.join(self.log_dir, "videos")
        if cfg.get("record_dataset_dir"):
            raise NotImplementedError(
                "record_dataset_dir: recording a dataset needs the sharded dataset "
                "writer of blurr_tpu.data, which the port has not ported yet "
                "(ROADMAP Queue 1, M13)"
            )
        os.makedirs(self.video_dir, exist_ok=True)
        if device is None:
            device = f"cuda:{int(cfg.get('gpu_id') or 0)}"
        self.device = torch.device(device)

        use_bf16 = bool(cfg.get("use_bf16", False))
        use_fp16 = bool(cfg.get("use_fp16", False))
        if use_bf16 and use_fp16:
            raise ValueError("Specify at most one of `use_bf16` or `use_fp16`.")
        if use_fp16:
            log.warning("FP16 requested; the port follows the JAX package — using bfloat16.")
            self.dtype = torch.bfloat16
        elif use_bf16:
            self.dtype = torch.bfloat16
        else:
            self.dtype = torch.float32
        if cfg.get("use_torch_compile"):
            log.info("use_torch_compile is set and has no effect: the port runs the "
                     "control step eagerly")

        log.info("Initializing PiZero (this may take some time)...")
        t0 = time.time()
        self.model = self._build_model()
        log.info("PiZero initialized in %.2f s", time.time() - t0)
        try:
            self.model.enable_action_quantization()
            self.model.enable_vlm_quantization()
        except Exception as exc:  # graceful like the reference (eval.py:74-78)
            log.warning(
                "Quantization failed, continuing with UNQUANTIZED weights "
                "(results do not reflect the quantized preset): %s", exc
            )
            # quantization is in place: a failure between the two enables
            # must not leave a half-quantized model, so build it again
            self.model = None
            self.model = self._build_model()
        self.model.eval()
        log.info("Using device: %s dtype: %s", self.device, self.dtype)
        log_allocated_device_memory(log, "loading model", self.device)

        self.act_steps = cfg["act_steps"]
        self.use_prefix_kv_cache = bool(cfg.get("use_prefix_kv_cache", True))
        # Async pipelined control: inference for the NEXT chunk is dispatched
        # after the first sub-step of the current chunk and fetched after the
        # last, so the device computes while the sim steps. Executed actions
        # are stale by act_steps-1 env steps (fresh actions still arrive
        # every act_steps). Opt-in; needs act_steps >= 2 to hide anything.
        self.async_pipeline = bool(cfg.get("async_pipeline", False))
        if self.async_pipeline and self.act_steps < 2:
            log.warning("async_pipeline needs act_steps >= 2; disabled.")
            self.async_pipeline = False
        self.seed = int(cfg.get("seed", 42))
        self._step_idx = 0

        log.info("Creating SimplerEnv env with task='%s'...", cfg["env"]["task"])
        t0 = time.time()
        self.env = make_env(cfg["env"]["task"])
        log.info("Env created in %.2f s", time.time() - t0)

        log.info("Instantiating env adapter: %s", cfg["env"]["adapter"]["_target_"])
        self.env_adapter = instantiate(cfg["env"]["adapter"])
        log.info("Env adapter instantiated.")

    def _build_model(self) -> PiZero:
        model = PiZero(self.cfg, device=self.device, dtype=self.dtype)
        return self.load_checkpoint(model, self.cfg.get("checkpoint_path"))

    @log_execution_time(log)
    def load_checkpoint(self, model: PiZero, path) -> PiZero:
        """A reference ``.pt`` checkpoint; empty/'random' gives deterministic
        random-init weights (smoke/latency mode)."""
        if not path or str(path).lower() in {"random", "none"}:
            log.warning("No checkpoint: using random-init weights.")
            return model.init_params(torch.Generator(device=self.device).manual_seed(0))
        load_checkpoint(model, str(path))
        log.info("Loaded model from %s", path)
        return model

    @staticmethod
    def _sanitize(out: np.ndarray) -> np.ndarray:
        """Non-finite action guard shared by the serial and batched fetch
        paths."""
        if not np.isfinite(out).all():
            log.warning("Non-finite actions (nan/inf) replaced with zeros.")
            out = np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
        return out

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the agent's device; to a card from pinned
        memory without waiting (a pageable copy would synchronize)."""
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def device_inputs(self, inputs: dict):
        """(ids, mask, pixel values, proprio) of one adapter output on the
        device, the floats in the model dtype."""
        ids, am, px, pr = (self._upload(inputs[k]) for k in _INPUT_KEYS)
        return ids, am, px.to(self.dtype), pr.to(self.dtype)

    def noise(self, step_idx: int, batch: int) -> torch.Tensor:
        """The flow noise of dispatch ``step_idx`` on the device: JAX's
        ``normal(fold_in(PRNGKey(seed), step_idx), (batch, horizon,
        action_dim), dtype)``."""
        s = self.model.spec
        key = prng.fold_in(prng.prng_key(self.seed), step_idx)
        return self._upload(
            prng.normal(key, (batch, s.num_action_tokens, s.action_dim), self.dtype)
        )

    def _infer_fn(self):
        return self.model.infer_action if self.use_prefix_kv_cache else self.model.infer_action_naive

    def _open_video_writer(self, stem: str):
        """Writer for ``stem`` + '.mp4', degrading to an animated GIF (the
        Pillow backend is always available) and then to disabled when imageio
        lacks an ffmpeg backend. Returns (writer, actual_path) or (None, None)."""
        if imageio is None:
            log.warning("imageio not installed; video recording disabled.")
            return None, None
        try:
            return imageio.get_writer(stem + ".mp4"), stem + ".mp4"
        except Exception as exc:  # no ffmpeg backend etc.
            try:
                w = imageio.get_writer(stem + ".gif", duration=0.2, loop=0)
                log.warning(
                    "mp4 backend unavailable (%s); recording GIF instead.", exc
                )
                return w, stem + ".gif"
            except Exception as exc2:
                log.warning("Video recording disabled (%s).", exc2)
                return None, None

    def _dispatch(self, inputs: dict) -> torch.Tensor:
        """Launch the control step WITHOUT fetching: the kernels are queued
        on the device's stream and the host returns (the async-pipeline
        mode overlaps them with env stepping)."""
        args = self.device_inputs(inputs)
        actions = self._infer_fn()(*args, self.noise(self._step_idx, args[0].shape[0]))
        self._step_idx += 1
        return actions

    def _fetch(self, pending: torch.Tensor) -> np.ndarray:
        return self._sanitize(pending[0].float().cpu().numpy())

    def _infer(self, inputs: dict) -> np.ndarray:
        return self._fetch(self._dispatch(inputs))

    def run(self):
        log.info(
            "EvalAgent.run start: n_eval_episode=%d, n_video=%d, act_steps=%d",
            self.n_eval_episode,
            self.n_video,
            self.act_steps,
        )
        env = self.env
        env_adapter = self.env_adapter
        cnt_episode = 0
        successes = []
        infer_times = []

        env_reset_options = {"obj_init_options": {"episode_id": cnt_episode}}
        obs, reset_info = env.reset(options=env_reset_options)
        env_adapter.reset()
        instruction = env.get_language_instruction()
        recording = self.n_video > 0
        video_writer = None

        def video_parent_path(x):
            return os.path.join(self.video_dir, f"video_{x}")

        video_path = None
        if recording:
            video_writer, video_path = self._open_video_writer(
                video_parent_path(cnt_episode)
            )
            recording = video_writer is not None
        log.info(
            "Reset info: %s Instruction: %s Max episode length: %s",
            reset_info,
            instruction,
            getattr(env.spec, "max_episode_steps", None),
        )
        step_in_episode = 0
        next_chunk = None  # async pipeline: prefetched chunk for next step
        fetch_waits = []
        while True:
            if next_chunk is None:
                inputs = env_adapter.preprocess(env, obs, instruction)
                t0 = time.time()
                actions = self._infer(inputs)
                infer_times.append(time.time() - t0)
                log.debug(
                    "Episode %d, step %d: model forward done in %.3f s.",
                    cnt_episode,
                    step_in_episode,
                    infer_times[-1],
                )
            else:
                actions = next_chunk
                next_chunk = None
            env_actions = env_adapter.postprocess(actions)

            truncated = False
            success = False
            pending = None
            for i, env_action in enumerate(env_actions[: self.act_steps]):
                step_in_episode += 1
                if step_in_episode % 10 == 0:
                    log.info(
                        "Episode %d, env step %d: stepping env...",
                        cnt_episode,
                        step_in_episode,
                    )
                obs, reward, success, truncated, info = env.step(env_action)
                if truncated:
                    break
                if self.async_pipeline and i == 0:
                    # dispatch the NEXT chunk from the post-first-sub-step
                    # obs; the device computes while the remaining
                    # act_steps-1 sub-steps run (actions land act_steps-1
                    # steps stale). Refresh the instruction FIRST so a
                    # mid-episode instruction switch conditions the
                    # prefetched chunk
                    instruction = env.get_language_instruction()
                    inputs = env_adapter.preprocess(env, obs, instruction)
                    pending = self._dispatch(inputs)
            if pending is not None and not truncated:
                t_wait = time.time()
                next_chunk = self._fetch(pending)
                fetch_waits.append(time.time() - t_wait)

            if recording and video_writer is not None:
                video_writer.append_data(env_adapter.get_video_frame(env, obs))

            new_instruction = env.get_language_instruction()
            if new_instruction != instruction:
                instruction = new_instruction

            if truncated:
                successes.append(success)
                log.info(
                    "Episode %d finished. success=%s, total_steps=%d",
                    cnt_episode,
                    success,
                    step_in_episode,
                )
                if recording and video_writer is not None:
                    video_writer.close()
                    if success and video_path is not None:
                        stem, ext = os.path.splitext(video_path)
                        os.rename(video_path, stem + "_success" + ext)
                cnt_episode += 1
                step_in_episode = 0
                next_chunk = None  # fresh episode must infer from new obs
                if cnt_episode >= self.n_eval_episode:
                    break
                env_reset_options["obj_init_options"] = {"episode_id": cnt_episode}
                obs, reset_info = env.reset(options=env_reset_options)
                env_adapter.reset()
                instruction = env.get_language_instruction()
                log.info(
                    f"Reset info: {reset_info} Instruction: {instruction} "
                    f"Max episode length: "
                    f"{getattr(env.spec, 'max_episode_steps', None)}"
                )
                recording = self.n_video > cnt_episode
                if recording:
                    video_writer, video_path = self._open_video_writer(
                        video_parent_path(cnt_episode)
                    )
                    recording = video_writer is not None

        success_rate = float(np.mean(successes)) if successes else 0.0
        # NOTE: the literal strings below are regex-matched by the result
        # collectors (collect_bridge_eval_results.py) — do not change.
        log.info("============ Evaluation Summary ============")
        log.info(f"Number of episodes: {cnt_episode}")
        log.info(f"Success rate: {success_rate}")
        if len(infer_times) > 1:
            # the first call includes the kernels' build and load; report it
            # separately
            steady = sorted(infer_times[1:])
            log.info(
                "Inference wall-clock: first %.1f ms (incl. compile), "
                "steady p50 %.1f ms / mean %.1f ms over %d steps",
                infer_times[0] * 1000,
                steady[len(steady) // 2] * 1000,
                float(np.mean(steady)) * 1000,
                len(steady),
            )
        if fetch_waits:
            w = sorted(fetch_waits)
            log.info(
                "Async pipeline: residual fetch wait p50 %.1f ms / mean "
                "%.1f ms over %d prefetched chunks (device time hidden "
                "behind env stepping)",
                w[len(w) // 2] * 1000,
                float(np.mean(w)) * 1000,
                len(w),
            )
        log_allocated_device_memory(log, "evaluation", self.device)
        log.info("============================================")
        return success_rate
