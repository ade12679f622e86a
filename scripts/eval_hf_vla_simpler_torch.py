#!/usr/bin/env python3
"""Evaluate an OpenVLA-family VLA on SimplerEnv Bridge tasks with the
PyTorch port (blurr_tpu_torch).

    python scripts/eval_hf_vla_simpler_torch.py --model-id /path/to/snapshot \\
        --task widowx_spoon_on_towel --preset blurr --quantization w4a8

The port's counterpart of scripts/eval_hf_vla_simpler.py, with its flags,
log lines ("Success rate:", the summary block) and summary.json keys. It
runs on the card: --device defaults to cuda and --gpu-id picks the card;
--device cpu runs the plain versions of the kernels (e.g. --device cpu
--model-id random for a tiny random model). With no card and no --device
cpu it fails on its first CUDA call: nothing falls back to the CPU.

--model-id takes an HF snapshot directory (its blurr_spec.json, else
OpenVLA-7B's widths; config.json's norm_stats merged with
dataset_statistics.json; OFT's action head and proprio projector where
their files are), or 'random' / 'random-7b' for random weights drawn on the
device from --seed. --quantization w8a8 / w4a8 quantizes the LLM: a
snapshot's by the memory-bounded streaming quantizer, random-7b's drawn
quantized (never in bf16), the tiny one's in place; every w4a8 product
goes through the port's int4 kernel. Without SimplerEnv (or with a task
named fake_*) the fake env is stepped. The step runs eagerly:
--use-torch-compile and --attn-implementation are accepted and have no
effect, and summary.json records torch_compile false. A snapshot's
lora_adapter/ directory (PEFT) is merged into the LLM as it loads unless
--use-lora off.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
from PIL import Image

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from blurr_tpu_torch.agent.hf_vla_utils import (  # noqa: E402
    bridge_action_to_simpler,
    center_crop_and_resize_back,
    infer_center_crop_default,
    inject_dataset_statistics_into_norm_stats,
    normalize_proprio,
    octo_style_preprocess,
    simpler_eef_pos_to_bridge_proprio,
    simpler_eef_pos_to_bridge_proprio_padded,
)
from blurr_tpu_torch.paths import repo_root  # noqa: E402

log = logging.getLogger("eval_hf_vla_simpler")


def _default_log_dir(*, tag: str, seed: int, task: Optional[str] = None) -> Path:
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    base = repo_root() / "runs" / "eval_bridge" / f"{tag}_{seed}"
    return base / (f"{task}_{stamp}" if task else stamp)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Evaluate a VLA (e.g., OpenVLA) on SimplerEnv Bridge tasks with the "
                    "PyTorch port."
    )
    p.add_argument("--model-id", type=str, required=True)
    p.add_argument("--preset", type=str, default="baseline", choices=["baseline", "blurr"],
                   help="baseline=FP32; blurr=BF16.")
    p.add_argument("--task", type=str, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; the card --gpu-id), cuda:N, or cpu "
                        "(the plain versions of the kernels)")
    p.add_argument("--gpu-id", type=int, default=0, help="the card of --device cuda")
    p.add_argument("--n-eval-episode", type=int, default=100)
    p.add_argument("--initial-states", type=str, default="eval",
                   choices=["eval", "train", "episode_id"])
    p.add_argument("--max-steps", type=int, default=150)
    p.add_argument("--num-steps-wait", type=int, default=0)
    p.add_argument("--log-dir", type=str, default="")
    p.add_argument("--prompt-template", type=str,
                   default="In: What action should the robot take to {instruction}?\nOut:")
    p.add_argument("--unnorm-key", type=str, default=None)
    p.add_argument("--attn-implementation", type=str, default="",
                   help="Accepted; no effect (the port's attention is its own).")
    p.add_argument("--use-bf16", action="store_true")
    p.add_argument("--quantization", type=str, default="none", choices=["none", "w8a8", "w4a8"],
                   help="Quantize the Llama decoder (w4a8 through the port's int4 kernel). "
                        "Experimental: validate success rates.")
    p.add_argument("--use-fp16", action="store_true")
    p.add_argument("--use-torch-compile", action="store_true",
                   help="Accepted; no effect (the step runs eagerly).")
    p.add_argument("--no-torch-compile", action="store_true")
    p.add_argument("--use-lora", type=str, default="auto", choices=["auto", "on", "off"])
    p.add_argument("--center-crop", type=str, default="auto", choices=["auto", "on", "off"])
    p.add_argument("--center-crop-scale", type=float, default=0.9)
    p.add_argument("--image-preproc", type=str, default="octo128", choices=["octo128", "raw"])
    p.add_argument("--normalize-proprio", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--use-oft-action-head", type=str, default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--use-oft-proprio", type=str, default="auto", choices=["auto", "on", "off"])
    return p.parse_args(argv)


def _build_model(args, dtype, device):
    """(model, processor, norm_stats, dataset_stats, is_oft, proprio_in):
    the model holds its weights on ``device``; ``dataset_stats``
    (dataset_statistics.json) takes part in the unnorm-key preference;
    ``proprio_in`` is the OFT proprio projector's input width (None
    without one)."""
    import torch

    from blurr_tpu_torch.models.openvla.llama import quantize_llama_streaming
    from blurr_tpu_torch.models.openvla.model import (
        RANDOM_SPECS,
        OpenVLA,
        OpenVLAOFT,
        OpenVLASpec,
    )
    from blurr_tpu_torch.models.openvla.processing import OpenVLAProcessor, load_hf_tokenizer

    quant = None if args.quantization == "none" else args.quantization
    model_path = Path(args.model_id).expanduser()
    head = proj = None
    norm_stats: Dict[str, Any] = {}
    dataset_stats: Dict[str, Any] = {}
    if model_path.is_dir():
        from blurr_tpu_torch.models.openvla.checkpoint import (
            load_dataset_statistics,
            load_oft_aux_params,
            load_openvla_hf_dir,
        )

        spec = OpenVLASpec.from_snapshot_dir(model_path)
        # dataset_statistics.json only feeds the injection and the key
        # preference; config.json's norm_stats is the base
        dataset_stats = load_dataset_statistics(str(model_path)) or {}
        cfg_path = model_path / "config.json"
        if cfg_path.exists():
            norm_stats = json.loads(cfg_path.read_text()).get("norm_stats") or {}
        norm_stats = inject_dataset_statistics_into_norm_stats(norm_stats, dataset_stats)
        if args.use_oft_action_head != "off":
            head, proj = load_oft_aux_params(str(model_path), device, dtype)
        if args.use_oft_proprio == "off":
            proj = None  # ablate the proprio conditioning even when shipped
        kw = dict(device=device, dtype=dtype)
        if head is not None:
            # the chunk length from the head's input width:
            # chunk_len * action_dim * llama_hidden
            per_tok = spec.action_dim * spec.llama.hidden_size
            chunk_len = max(1, head.fc1.in_features // per_tok)
            if chunk_len * per_tok != head.fc1.in_features:
                log.warning("OFT head input width %d is not a multiple of "
                            "action_dim*hidden=%d; using chunk_len=%d.",
                            head.fc1.in_features, per_tok, chunk_len)
            model = OpenVLAOFT(spec, norm_stats, chunk_len, use_proprio=proj is not None,
                               proprio_dim=proj.fc1.in_features if proj is not None else 8, **kw)
        else:
            model = OpenVLA(spec, norm_stats, **kw)
        load_openvla_hf_dir(model, str(model_path), lora=args.use_lora != "off")
        if head is not None:
            model.action_head = head
            model.proprio_projector = proj
        if quant:
            # each fp weight freed as its quantized form lands
            quantize_llama_streaming(model.llama, quant)
        tokenizer = load_hf_tokenizer(str(model_path))
    else:
        # random-7b: OpenVLA-7B's widths; any other id the tiny spec
        spec = RANDOM_SPECS["random-7b"]() if args.model_id == "random-7b" else OpenVLASpec.tiny()
        generator = torch.Generator(device=device).manual_seed(args.seed)
        if quant and args.model_id == "random-7b":
            # drawn quantized: a 7B never exists in bf16
            model = OpenVLA(spec, device=device, dtype=dtype, quant_init=quant)
        else:
            model = OpenVLA(spec, device=device, dtype=dtype)
        model.init_params(generator)
        if quant and args.model_id != "random-7b":
            quantize_llama_streaming(model.llama, quant)
        tokenizer = None
    processor = OpenVLAProcessor(tokenizer, image_size=spec.siglip.image_size,
                                 fused=spec.use_fused_vision)
    return (model.eval(), processor, norm_stats, dataset_stats, head is not None,
            proj.fc1.in_features if proj is not None else None)


def _proprio(obs, expected: int, norm_stats, unnorm_key, normalize: str):
    """The OFT proprio [1, expected] from SimplerEnv's 8D eef_pos: Bridge's
    7D [xyz, rpy, gripper] or its padded 8D form, by the projector's input
    width; None where eef_pos is too short."""
    eef = np.asarray(obs["agent"]["eef_pos"], np.float32).reshape(-1)
    if expected == 7 and eef.shape[0] == 8:
        pr = simpler_eef_pos_to_bridge_proprio(eef)
    elif expected == 8 and eef.shape[0] == 8:
        pr = simpler_eef_pos_to_bridge_proprio_padded(eef)
    else:
        pr = eef[:expected] if eef.shape[0] >= expected else None
    if pr is not None and normalize != "off":
        pr = normalize_proprio(pr, norm_stats=norm_stats, unnorm_key=unnorm_key)
    return None if pr is None else pr[None]


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from blurr_tpu_torch.agent.env_adapter.simpler import get_image_from_obs
    from blurr_tpu_torch.agent.fake_env import make_env
    from blurr_tpu_torch.models.openvla.checkpoint import infer_unnorm_key

    tasks = list(args.task)
    if "{instruction}" not in args.prompt_template:
        raise ValueError("--prompt-template must contain '{instruction}'")

    use_bf16 = args.use_bf16 or args.preset == "blurr"
    dtype = torch.bfloat16 if (use_bf16 or args.use_fp16) else torch.float32
    device = f"cuda:{args.gpu_id}" if args.device == "cuda" else args.device

    log_dir = (Path(args.log_dir).expanduser() if args.log_dir
               else _default_log_dir(tag=f"hf_{args.preset}", seed=args.seed))
    log_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        handlers=[logging.FileHandler(log_dir / "run.log"), logging.StreamHandler(sys.stdout)],
        force=True,
    )
    if args.use_torch_compile or args.attn_implementation:
        log.info("--use-torch-compile / --attn-implementation have no effect: the port runs "
                 "the step eagerly with its own attention.")

    model, processor, norm_stats, dataset_stats, is_oft, proprio_in = _build_model(
        args, dtype, device)
    unnorm_key = None
    if norm_stats:
        try:
            # bridge_orig > the first dataset-statistics key also in
            # norm_stats > the first norm_stats key
            unnorm_key = infer_unnorm_key(norm_stats, args.unnorm_key,
                                          dataset_stats=dataset_stats)
        except KeyError:
            unnorm_key = next(iter(norm_stats), None)
    action_stats = (norm_stats.get(unnorm_key) or {}).get("action") if unnorm_key else None

    do_center_crop = args.center_crop == "on"
    if args.center_crop == "auto":
        do_center_crop = infer_center_crop_default(args.model_id)
    resize_size = model.spec.siglip.image_size

    dummy_action = np.array([0, 0, 0, 0, 0, 0, -1], np.float32)
    per_task: Dict[str, float] = {}
    for task in tasks:
        log.info("Creating SimplerEnv env with task='%s'...", task)
        env = make_env(task)
        successes = []
        for episode_id in range(args.n_eval_episode):
            if args.initial_states == "episode_id":
                obs, _ = env.reset(options={"obj_init_options": {"episode_id": episode_id}})
            else:
                seed_base = 1000 if args.initial_states == "eval" else 0
                try:
                    obs, _ = env.reset(seed=seed_base + episode_id)
                except TypeError:
                    obs, _ = env.reset(options={"obj_init_options": {"episode_id": episode_id}})
            instruction = env.get_language_instruction()
            log.info("[%s] Episode %d reset: instruction='%s'", task, episode_id, instruction)

            step_in_episode = 0
            terminated = truncated = False
            while (step_in_episode < args.max_steps + args.num_steps_wait
                   and not (terminated or truncated)):
                if step_in_episode < args.num_steps_wait:
                    obs, _, terminated, truncated, _ = env.step(dummy_action)
                    step_in_episode += 1
                    continue

                prompt = args.prompt_template.format(instruction=instruction)
                image = Image.fromarray(
                    np.asarray(get_image_from_obs(env, obs), np.uint8)).convert("RGB")
                if args.image_preproc == "octo128":
                    image = octo_style_preprocess(image, resize_size=resize_size, base_size=128)
                if do_center_crop:
                    image = center_crop_and_resize_back(image, crop_scale=args.center_crop_scale)
                batch = processor(prompt, np.asarray(image))

                kwargs: Dict[str, Any] = {"unnorm_key": unnorm_key}
                if is_oft and proprio_in is not None:
                    pr = _proprio(obs, proprio_in, norm_stats, unnorm_key, args.normalize_proprio)
                    if pr is not None:
                        kwargs["proprio"] = pr
                action = model.predict_action(batch["input_ids"], batch["pixel_values"], **kwargs)
                action_seq = np.asarray(action, np.float32)
                if action_seq.ndim == 1:
                    action_seq = action_seq.reshape(1, -1)

                for sub_action in action_seq:
                    if step_in_episode >= args.max_steps + args.num_steps_wait:
                        break
                    env_action = bridge_action_to_simpler(sub_action, action_stats=action_stats)
                    if not np.isfinite(env_action).all():
                        env_action = np.nan_to_num(env_action)
                    obs, _, terminated, truncated, _ = env.step(env_action)
                    step_in_episode += 1
                    instruction = env.get_language_instruction()
                    if terminated or truncated:
                        break

            successes.append(bool(terminated))
            log.info("[%s] Episode %d finished: success=%s steps=%d truncated=%s",
                     task, episode_id, terminated, step_in_episode, truncated)
        rate = float(np.mean(successes)) if successes else 0.0
        per_task[task] = rate
        log.info("[%s] Success rate: %.4f over %d episodes", task, rate, len(successes))

    avg_success = float(np.mean(list(per_task.values()))) if per_task else 0.0
    summary = {
        "model_id": args.model_id,
        "preset": args.preset,
        "quantization": args.quantization,
        "dtype": str(dtype),
        "torch_compile": False,
        "attn_implementation": args.attn_implementation,
        "image_preproc": args.image_preproc,
        "center_crop": args.center_crop,
        "center_crop_scale": float(args.center_crop_scale),
        "normalize_proprio": args.normalize_proprio,
        "use_oft_action_head": args.use_oft_action_head,
        "use_oft_proprio": args.use_oft_proprio,
        "seed": int(args.seed),
        "initial_states": args.initial_states,
        "max_steps": int(args.max_steps),
        "num_steps_wait": int(args.num_steps_wait),
        "episodes_per_task": int(args.n_eval_episode),
        "per_task_success": per_task,
        "avg_success": avg_success,
    }
    with open(log_dir / "summary.json", "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2, sort_keys=True)

    log.info("============ Evaluation Summary ============")
    log.info("Tasks: %s", ", ".join(tasks))
    log.info("Episodes per task: %d", args.n_eval_episode)
    log.info("Avg success: %.4f", avg_success)
    log.info("Wrote: %s", log_dir / "summary.json")
    log.info("============================================")
    print(f"\nDone. Logs written to: {log_dir}\n")


if __name__ == "__main__":
    main()
