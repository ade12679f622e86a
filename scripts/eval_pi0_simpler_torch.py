#!/usr/bin/env python3
"""Closed-loop Pi-0 evaluation in SimplerEnv (Bridge / Fractal tasks) with
the PyTorch port (blurr_tpu_torch).

    python scripts/eval_pi0_simpler_torch.py --task widowx_spoon_on_towel \\
        --checkpoint random --config config/eval/bridge.yaml --preset blurr

The port's counterpart of scripts/eval_pi0_simpler.py, with its flags,
presets (blurr_tpu_torch/presets.py), defaults, log-dir layout
``runs/eval_bridge/<preset>_<seed>/<task>_<timestamp>/run.log`` and summary
lines ("Success rate:" / "Number of episodes:", which
scripts/collect_bridge_eval_results.py parses). It runs on the card:
--device defaults to cuda and --gpu-id picks the card; --device cpu runs
the plain versions of the kernels. Without SimplerEnv (or with a task
named fake_*) the agent steps the fake env. --checkpoint random draws
random weights on the device; a path loads a reference .pt checkpoint.
--batch-envs N steps N envs in lockstep with one batched control step.
use_torch_compile (the blurr preset sets it) is read and has no effect.
--record-dataset is not ported (it needs the dataset writer of ROADMAP
M13) and exits non-zero.

Preset semantics:
    baseline / vanilla   fp32, NO prefix KV cache, 10 flow steps
    prefix_cache / cached fp32 + prefix KV cache, 10 flow steps
    blurr / step1        bf16 + prefix KV cache, 1 flow step
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def _default_log_dir(preset: str | None, task: str, seed: int) -> Path:
    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    return (
        REPO_ROOT / "runs" / "eval_bridge"
        / f"{preset or 'custom'}_{seed}" / f"{task}_{stamp}"
    )


def _setup_logging(log_dir: Path) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        handlers=[
            logging.FileHandler(log_dir / "run.log"),
            logging.StreamHandler(sys.stdout),
        ],
        force=True,
    )


def parse_args(argv=None) -> argparse.Namespace:
    from blurr_tpu_torch.presets import ALIASES, PRESETS

    parser = argparse.ArgumentParser(
        description="Run BLURR Pi0 evaluation in SimplerEnv (Bridge/Fractal tasks) "
                    "with the PyTorch port."
    )
    parser.add_argument("--task", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument(
        "--config", type=str, default="config/eval/bridge.yaml",
        help="Eval config path, absolute or relative to the blurr_tpu package.",
    )
    parser.add_argument(
        "--preset", type=str, default="blurr",
        choices=sorted(PRESETS) + sorted(ALIASES),
        help="Named toggle bundle (prefix KV cache / BF16 / compile / steps).",
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default; the card --gpu-id), "
                             "cuda:N, or cpu (the plain versions of the kernels)")
    parser.add_argument("--gpu-id", type=int, default=0,
                        help="the card of --device cuda")
    parser.add_argument("--n-eval-episode", type=int, default=240)
    parser.add_argument("--n-video", type=int, default=0)
    parser.add_argument(
        "--log-dir", type=str, default="",
        help="Output dir (default runs/eval_bridge/<preset>_<seed>/<task>_<ts>/).",
    )
    # manual overrides applied after the preset
    parser.add_argument("--use-bf16", action="store_true")
    parser.add_argument("--no-torch-compile", action="store_true")
    parser.add_argument("--no-prefix-kv-cache", action="store_true")
    parser.add_argument("--num-inference-steps", type=int, default=0)
    parser.add_argument("--act-steps", type=int, default=0)
    parser.add_argument(
        "--async-pipeline", action="store_true",
        help="Overlap inference with env stepping: the next chunk is "
             "dispatched after the first sub-step of the current one "
             "(actions land act_steps-1 env steps stale; needs act_steps>=2).")
    parser.add_argument(
        "--record-dataset", type=str, default="",
        help="Not ported: recording a dataset needs the dataset writer of "
             "ROADMAP M13; the run exits non-zero.")
    parser.add_argument(
        "--batch-envs", type=int, default=1,
        help="Step N environments in lockstep with one batched control step "
             "per round. Per-episode semantics match the serial agent; videos "
             "are unavailable in this mode.")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.record_dataset:
        sys.exit("--record-dataset is not ported to blurr_tpu_torch: it needs the "
                 "sharded dataset writer of blurr_tpu.data (ROADMAP Queue 1, M13). "
                 "Record with scripts/eval_pi0_simpler.py.")

    from blurr_tpu_torch.presets import apply_preset, load_config

    cfg = load_config(args.config)
    apply_preset(cfg, args.preset)

    # runtime settings from the CLI
    cfg["env"]["task"] = args.task
    cfg["checkpoint_path"] = str(Path(args.checkpoint).expanduser())
    cfg["seed"] = args.seed
    cfg["gpu_id"] = args.gpu_id
    cfg["n_eval_episode"] = args.n_eval_episode
    cfg["n_video"] = args.n_video

    # manual overrides win over the preset
    if args.use_bf16:
        cfg["use_bf16"] = True
    if args.no_torch_compile:
        cfg["use_torch_compile"] = False
    if args.no_prefix_kv_cache:
        cfg["use_prefix_kv_cache"] = False
    if args.num_inference_steps > 0:
        cfg["num_inference_steps"] = args.num_inference_steps
    if args.act_steps > 0:
        cfg["act_steps"] = args.act_steps
    if args.async_pipeline:
        cfg["async_pipeline"] = True

    log_dir = (
        Path(args.log_dir).expanduser()
        if args.log_dir
        else _default_log_dir(args.preset, args.task, args.seed)
    )
    log_dir.mkdir(parents=True, exist_ok=True)
    cfg["log_dir"] = str(log_dir)
    _setup_logging(log_dir)
    device = f"cuda:{args.gpu_id}" if args.device == "cuda" else args.device

    if args.batch_envs > 1:
        from blurr_tpu_torch.agent.batched_eval import BatchedEvalAgent

        cfg["batch_envs"] = args.batch_envs
        BatchedEvalAgent(cfg, device=device).run()
    else:
        from blurr_tpu_torch.agent.eval_agent import EvalAgent

        EvalAgent(cfg, device=device).run()
    print(f"\nDone. Logs written to: {log_dir}\n")


if __name__ == "__main__":
    main()
