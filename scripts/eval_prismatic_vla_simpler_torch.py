#!/usr/bin/env python3
"""Evaluate a prismatic-style VLA (MiniVLA) on SimplerEnv Bridge tasks with
the PyTorch port (blurr_tpu_torch).

    python scripts/eval_prismatic_vla_simpler_torch.py \\
        --checkpoint run_dir/checkpoints/step-010000.pt --task widowx_spoon_on_towel

The port's counterpart of scripts/eval_prismatic_vla_simpler.py, with its
flags, log lines and summary.json keys: a single SigLIP tower, a 2-linear
projector and a compact LLM backbone (MiniVLA's Qwen2.5-0.5B widths) with
the greedy action-token decode. It runs on the card: --device defaults to
cuda and --gpu-id picks the card; --device cpu runs on the CPU. With no
card and no --device cpu it fails on its first CUDA call.

--checkpoint takes a prismatic .pt (a state dict, or {"model": state},
loaded with torch.load(weights_only=True)); in the run_dir/checkpoints/*.pt
layout the run dir's dataset_statistics.json gives the normalization keys,
and the vocabulary, the q/k/v biases and the tied head are read from the
state dict. A part of the model whose key layout is not recognized stays
random, with a "PARTIAL LOAD" warning. --checkpoint random runs random
weights drawn on the device from --seed. The bundled Bridge statistics
(blurr_tpu/config/bridge_statistics.json, read as data) are the default
bridge_orig.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np
from PIL import Image

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from blurr_tpu_torch.agent.hf_vla_utils import (  # noqa: E402
    bridge_action_to_simpler,
    octo_style_preprocess,
)
from blurr_tpu_torch.paths import config_root, repo_root  # noqa: E402

log = logging.getLogger("eval_prismatic_vla_simpler")

# token-id ceiling for action de-tokenization (discretized =
# action_token_vocab - token_id): the REAL tokenizer vocab, not the padded
# embedding rows. Known paddings: llama-2 32064 -> 32000, Qwen2/2.5
# 151936 -> 151643.
TOKENIZER_VOCAB_BY_EMBED_ROWS = {32064: 32000, 151936: 151643}


def minivla_spec(vocab_size: int = 32064):
    """MiniVLA's prismatic spec (``OpenVLASpec.minivla``); tests replace it
    with a tiny one."""
    from blurr_tpu_torch.models.openvla.model import OpenVLASpec

    return OpenVLASpec.minivla(vocab_size)


def _infer_unnorm_key(norm_stats, dataset_stats, override):
    """An explicit override; else the first dataset-statistics key also in
    norm_stats; else 'bridge_dataset'; else the first norm_stats key."""
    if override:
        return override
    norm_keys = list(norm_stats.keys())
    if dataset_stats:
        inter = [k for k in dataset_stats.keys() if k in norm_keys]
        if inter:
            return inter[0]
    if "bridge_dataset" in norm_keys:
        return "bridge_dataset"
    return norm_keys[0] if norm_keys else "bridge_dataset"


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a prismatic VLA (.pt) on SimplerEnv Bridge tasks with the "
                    "PyTorch port."
    )
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Prismatic .pt checkpoint, or 'random'.")
    p.add_argument("--task", type=str, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; the card --gpu-id), cuda:N, or cpu")
    p.add_argument("--gpu-id", type=int, default=0, help="the card of --device cuda")
    p.add_argument("--n-eval-episode", type=int, default=100)
    p.add_argument("--max-steps", type=int, default=150)
    p.add_argument("--initial-states", type=str, default="eval",
                   choices=["eval", "train", "episode_id"])
    p.add_argument("--log-dir", type=str, default="")
    p.add_argument("--unnorm-key", type=str, default=None,
                   help="Explicit normalization-statistics key; inferred from the checkpoint "
                        "run dir's dataset_statistics.json when omitted.")
    p.add_argument("--use-bf16", action="store_true", default=True)
    p.add_argument("--fp32", action="store_true",
                   help="Force float32 (--use-bf16 defaults on; this is the only way to get "
                        "an fp32 precision-ablation run).")
    p.add_argument("--image-preproc", type=str, default="octo128", choices=["octo128", "raw"])
    p.add_argument("--num-steps-wait", type=int, default=0,
                   help="No-op settle steps ([0,0,0,0,0,0,-1]) at episode start.")
    p.add_argument("--instruction-template", type=str, default="{instruction}",
                   help="Prompt template; must contain '{instruction}'.")
    return p.parse_args(argv)


def _bridge_norm_stats() -> dict:
    """The bundled Bridge statistics as the default ``bridge_orig``."""
    bridge = json.loads((config_root() / "bridge_statistics.json").read_text())
    return {"bridge_orig": {"action": {"q01": bridge["action"]["p01"],
                                       "q99": bridge["action"]["p99"],
                                       "mask": [True] * 6 + [False]}}}


def _read_checkpoint(path: str):
    """(state dict, dataset statistics) of a prismatic ``.pt``; in the
    run_dir/checkpoints/*.pt layout the statistics sit in the run dir."""
    import torch

    ckpt = Path(path).expanduser()
    run_dir = ckpt.parents[1] if ckpt.parent.name == "checkpoints" else ckpt.parent
    dataset_stats = {}
    ds_path = run_dir / "dataset_statistics.json"
    if ds_path.is_file():
        try:
            dataset_stats = json.loads(ds_path.read_text())
        except ValueError:
            dataset_stats = {}
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    return state.get("model", state), dataset_stats


def _spec_of(state):
    """MiniVLA's spec with the vocabulary, the q/k/v biases and the tied
    head of the state dict's LLM (where it has an embedding)."""
    from dataclasses import replace

    key = "llm_backbone.llm.model.embed_tokens.weight"
    if state is None or key not in state:
        return minivla_spec()
    vocab = int(state[key].shape[0])
    spec = minivla_spec(vocab_size=vocab)
    has_bias = any(k.endswith("self_attn.q_proj.bias") for k in state)
    tied = "llm_backbone.llm.lm_head.weight" not in state
    if vocab not in TOKENIZER_VOCAB_BY_EMBED_ROWS:
        log.warning("Unknown vocab padding for embedding rows=%d; assuming the action-token "
                    "ceiling equals it (override with the spec if actions detokenize to "
                    "constants).", vocab)
    return replace(spec, llama=replace(spec.llama, qkv_bias=has_bias, tie_word_embeddings=tied),
                   action_token_vocab=TOKENIZER_VOCAB_BY_EMBED_ROWS.get(vocab, vocab))


def _load_state(model, state, name: str) -> None:
    """The state dict's LLM, and its vision tower with the projector, into
    ``model``; a part whose layout is not recognized (a key missing, a shape
    the spec does not have) stays random, with a warning."""
    from torch import nn

    from blurr_tpu_torch.models.openvla.checkpoint import (
        llama_pairs,
        llama_params_from_hf,
        prismatic_vision_params,
        projector_pairs,
        vit_pairs,
    )
    from blurr_tpu_torch.models.pi0.checkpoint import copy_pairs

    def llm():
        tree = llama_params_from_hf(state, prefix="llm_backbone.llm.")
        return model.llama, list(llama_pairs(model.llama, tree))

    def vision():
        vis, proj = prismatic_vision_params(state, model.spec)
        pairs = [*vit_pairs(model.siglip, vis), *projector_pairs(model.projector, proj)]
        return nn.ModuleList([model.siglip, model.projector]), pairs

    loaded, random_init = [], []
    for part, what, pairs_of in (("llama", "LLM backbone", llm),
                                 ("siglip+projector", "Vision/projector", vision)):
        try:
            root, pairs = pairs_of()
            bad = [(tuple(a.shape), tuple(p.shape)) for p, a in pairs
                   if tuple(a.shape) != tuple(p.shape)]
            if bad:
                raise ValueError(f"shapes {bad[:4]} against the spec's")
            copy_pairs(root, pairs)
            loaded.append(part)
        except (KeyError, ValueError) as exc:
            log.warning("%s layout not recognized (%s).", what, exc)
            random_init.append(part)
    if loaded:
        log.info("Loaded from %s: %s", name, ", ".join(loaded))
    if random_init:
        log.warning("PARTIAL LOAD: %s stayed RANDOM-INIT — actions will be meaningless unless "
                    "this is a smoke run.", ", ".join(random_init))


def prismatic_state_dict(model) -> Dict:
    """The inverse of ``_load_state``, to check it: the prismatic .pt key
    map of a single-tower model (MiniVLA), the model's own tensors or views
    of them: the LLM under ``llm_backbone.llm.``, SigLIP under
    ``vision_backbone.featurizer.``, the projector's two linears as
    ``projector.projector.{0,2}``."""
    from blurr_tpu_torch.models.openvla.checkpoint import _llama_keys, _vit_keys

    if model.dinov2 is not None:
        raise ValueError("a prismatic checkpoint holds one vision tower; this model fuses two")
    out = _llama_keys(model.llama, "llm_backbone.llm.")
    out.update(_vit_keys(model.siglip, "vision_backbone.featurizer."))
    for i, name in ((0, "fc1"), (2, "fc2")):
        out[f"projector.projector.{i}.weight"] = getattr(model.projector, name).weight
        out[f"projector.projector.{i}.bias"] = getattr(model.projector, name).bias
    return out


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from blurr_tpu_torch.agent.env_adapter.simpler import get_image_from_obs
    from blurr_tpu_torch.agent.fake_env import make_env
    from blurr_tpu_torch.models.openvla.model import OpenVLA
    from blurr_tpu_torch.models.openvla.processing import OpenVLAProcessor

    log_dir = (Path(args.log_dir).expanduser() if args.log_dir
               else repo_root() / "runs" / "eval_bridge" / f"prismatic_{args.seed}"
               / time.strftime("%Y-%m-%d_%H-%M-%S"))
    log_dir.mkdir(parents=True, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        handlers=[logging.FileHandler(log_dir / "run.log"), logging.StreamHandler(sys.stdout)],
        force=True,
    )
    if "{instruction}" not in args.instruction_template:
        raise ValueError("--instruction-template must contain '{instruction}'")

    dtype = torch.float32 if args.fp32 else torch.bfloat16
    device = f"cuda:{args.gpu_id}" if args.device == "cuda" else args.device
    norm_stats = _bridge_norm_stats()

    is_random = str(args.checkpoint).lower() in {"random", "none", ""}
    state, dataset_stats = None, {}
    if not is_random:
        state, dataset_stats = _read_checkpoint(args.checkpoint)
        # each dataset's action statistics join norm_stats (the prismatic
        # checkpoint's vla.norm_stats)
        for key, st in (dataset_stats or {}).items():
            act = st.get("action", st) if isinstance(st, dict) else {}
            if isinstance(act, dict) and "q01" in act and "q99" in act:
                norm_stats[key] = {"action": act}

    spec = _spec_of(state)
    model = OpenVLA(spec, norm_stats, device=device, dtype=dtype)
    model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    if not is_random:
        _load_state(model, state, args.checkpoint)
    model.eval()

    unnorm_key = _infer_unnorm_key(norm_stats, dataset_stats, args.unnorm_key)
    log.info("Using unnorm_key=%s", unnorm_key)

    processor = OpenVLAProcessor(None, image_size=spec.siglip.image_size, fused=False)
    action_stats = norm_stats.get(unnorm_key, norm_stats["bridge_orig"])["action"]
    dummy_action = np.array([0, 0, 0, 0, 0, 0, -1], dtype=np.float32)

    per_task: Dict[str, float] = {}
    for task in args.task:
        env = make_env(task)
        successes = []
        for episode_id in range(args.n_eval_episode):
            if args.initial_states == "episode_id":
                obs, _ = env.reset(options={"obj_init_options": {"episode_id": episode_id}})
            else:
                base = 1000 if args.initial_states == "eval" else 0
                try:
                    obs, _ = env.reset(seed=base + episode_id)
                except TypeError:
                    obs, _ = env.reset(options={"obj_init_options": {"episode_id": episode_id}})
            instruction = env.get_language_instruction()
            terminated = truncated = False
            steps = 0
            while steps < args.max_steps + args.num_steps_wait and not (terminated or truncated):
                if steps < args.num_steps_wait:
                    # settle steps: a no-op action while objects come to rest
                    obs, _, terminated, truncated, _ = env.step(dummy_action)
                    steps += 1
                    continue
                image = Image.fromarray(
                    np.asarray(get_image_from_obs(env, obs), np.uint8)).convert("RGB")
                if args.image_preproc == "octo128":
                    image = octo_style_preprocess(image, resize_size=spec.siglip.image_size)
                templated = args.instruction_template.format(instruction=instruction)
                prompt = f"In: What action should the robot take to {templated.lower()}?\nOut:"
                batch = processor(prompt, np.asarray(image))
                action = model.predict_action(batch["input_ids"], batch["pixel_values"],
                                              unnorm_key=unnorm_key)
                env_action = bridge_action_to_simpler(action, action_stats=action_stats,
                                                      variant="prismatic")
                if not np.isfinite(env_action).all():
                    env_action = np.nan_to_num(env_action)
                obs, _, terminated, truncated, _ = env.step(env_action)
                steps += 1
                instruction = env.get_language_instruction()
            successes.append(bool(terminated))
            log.info("[%s] Episode %d finished: success=%s steps=%d",
                     task, episode_id, terminated, steps)
        rate = float(np.mean(successes)) if successes else 0.0
        per_task[task] = rate
        log.info("[%s] Success rate: %.4f over %d episodes", task, rate, len(successes))

    avg = float(np.mean(list(per_task.values()))) if per_task else 0.0
    summary = {
        "checkpoint": args.checkpoint,
        "unnorm_key": unnorm_key,
        "num_steps_wait": int(args.num_steps_wait),
        "dtype": str(dtype),
        "seed": int(args.seed),
        "initial_states": args.initial_states,
        "max_steps": int(args.max_steps),
        "episodes_per_task": int(args.n_eval_episode),
        "per_task_success": per_task,
        "avg_success": avg,
    }
    with open(log_dir / "summary.json", "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    log.info("Avg success: %.4f", avg)
    log.info("Wrote: %s", log_dir / "summary.json")
    print(f"\nDone. Logs written to: {log_dir}\n")


if __name__ == "__main__":
    main()
