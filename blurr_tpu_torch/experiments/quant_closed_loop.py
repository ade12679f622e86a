"""Closed-loop quantization divergence on the Pi-0 stack.

Counterpart of ``experiments/quant_closed_loop.py``. Open-loop, a quantized
tier moves each action chunk a little; this asks whether that noise
compounds through the control loop. The fake env is action-coupled (its
observations are functions of the integrated actions), so quantization
noise feeds back through proprio and pixels.

Protocol: one random bf16 draw per dims group (``base_params``), which
every variant of the group copies and quantizes; the same episode seeds and
noise stream (``split`` chains from ``PRNGKey(42)``, ``ops/prng.py``, JAX's
bits); EPISODES episodes rolled to the end. Each quantized variant is
reported against its dims-matched bf16 control: the first chunk's action
MAE and max, and the per-step end-effector divergence (mean, max, final).
The GPTQ variants calibrate on 6 control steps of the fp model in episode
100 (``_calib_batches``), then quantize with ``models/pi0/calibrate.py``.

    python -m blurr_tpu_torch.experiments.quant_closed_loop \\
        pool64_bf16 pool64_w4a8 pool64_w4a8_gptq

runs the named variants (and their controls; none named: all) on the card;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import gc
import sys

import numpy as np
import torch

import blurr_tpu_torch.agent.env_adapter.simpler  # noqa: F401  (registers adapters)
from blurr_tpu_torch.agent.fake_env import FakeSimplerEnv
from blurr_tpu_torch.config.core import instantiate, load_yaml
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops import prng
from blurr_tpu_torch.paths import config_root

EPISODES = 2
SEED = 42

# variant -> (base yaml, quant override)
VARIANTS = {
    # full bridge.yaml dims, act_steps 4
    "bf16": ("bridge.yaml", None),
    "bf16_rerun": ("bridge.yaml", None),  # determinism control
    "w8a8": ("bridge.yaml", "w8a8"),
    "w4a8": ("bridge.yaml", "w4a8"),
    "int8kv": ("bridge.yaml", "int8kv"),
    # the w4a8 accuracy ladder: finer groups and mixed precision
    "w4a8_g128": ("bridge.yaml", "w4a8_g128"),
    "w4a8_mixed": ("bridge.yaml", "w4a8_mixed"),
    "w4a8_g128_mixed": ("bridge.yaml", "w4a8_g128_mixed"),
    # the shipped pool64 pad96 presets (their control: the same preset with
    # quantization off)
    "pool64_bf16": ("bridge_pool64_w8a8_steps1.yaml", "none"),
    "pool64_w8a8": ("bridge_pool64_w8a8_steps1.yaml", None),
    "pool64_w4a8": ("bridge_pool64_w4a8_steps1.yaml", None),
    # GPTQ rounding against the model's own fake-env inputs: the same
    # {"q4", "s"} format and presets, only the rounding differs
    "w4a8_gptq": ("bridge.yaml", "w4a8_gptq"),
    "pool64_w4a8_gptq": ("bridge_pool64_w4a8_steps1.yaml", "gptq"),
}

# each quantized variant against its dims-matched bf16 control
CONTROL = {
    "bf16_rerun": "bf16",
    "w8a8": "bf16",
    "w4a8": "bf16",
    "w4a8_g128": "bf16",
    "w4a8_mixed": "bf16",
    "w4a8_g128_mixed": "bf16",
    "w4a8_gptq": "bf16",
    "int8kv": "bf16",
    "pool64_w8a8": "pool64_bf16",
    "pool64_w4a8": "pool64_bf16",
    "pool64_w4a8_gptq": "pool64_bf16",
}


def variant_cfg(yaml_name: str, quant):
    cfg = load_yaml(config_root() / "eval" / yaml_name)
    cfg["num_inference_steps"] = 1
    cfg["use_bf16"] = True
    if yaml_name == "bridge.yaml":
        cfg["act_steps"] = 4
    if quant == "w8a8":
        cfg["vlm_quantization"] = {"mode": "w8a8", "include_vision": True}
        cfg["action_quantization"] = {"mode": "w8a8"}
    elif quant and quant.startswith("w4a8"):
        # the bridge_pool64_w4a8 recipe at full dims (+ accuracy knobs)
        vq = {"mode": "w4a8", "include_vision": True}
        aq = {"mode": "w4a8"}
        if "g128" in quant:
            vq["group_size"] = aq["group_size"] = 128
        if "mixed" in quant:
            vq["int8_keys"] = aq["int8_keys"] = ["down_w"]
        cfg["vlm_quantization"] = vq
        cfg["action_quantization"] = aq
    elif quant == "int8kv":
        cfg["kv_quantization"] = {"mode": "int8", "activation_clip": 1.0, "dtype": "bfloat16"}
    elif quant == "none":
        cfg["vlm_quantization"] = {"mode": None}
        cfg["action_quantization"] = {"mode": None}
        cfg["kv_quantization"] = {"mode": None}
    return cfg


def base_params(yaml_name: str, device) -> dict:
    """One random bf16 draw per dims group (a generator seeded with 0), as a
    state dict every variant of the group copies: the divergence is then
    the quantization's alone."""
    model = PiZero(variant_cfg(yaml_name, None), device=device, dtype=torch.bfloat16)
    model.init_params(torch.Generator(device=device).manual_seed(0))
    return model.state_dict()


def _inputs(inputs: dict, device):
    """The adapter's (ids, mask, pixel values, proprio) on the device, the
    floats in bf16."""
    return (inputs["input_ids"].to(device), inputs["attention_mask"].to(device),
            inputs["pixel_values"].to(device, torch.bfloat16),
            inputs["proprios"].to(device, torch.bfloat16))


def _noise(rng, model, device):
    rng, sub = prng.split(rng)
    s = model.spec
    return rng, prng.normal(sub, (1, s.num_action_tokens, s.action_dim), torch.bfloat16, device)


def _calib_batches(model, adapter, cfg, device, n_steps: int = 6,
                   episode_id: int = 100) -> list:
    """Calibration observations from driving the fake env with the fp model
    for a few control steps (episode 100, apart from the rollout's), through
    the adapter's preprocessing: the inputs the quantized model will see.
    Another ``episode_id`` draws held-out observations."""
    env = FakeSimplerEnv()
    rng = prng.prng_key(123)
    obs, _ = env.reset(options={"obj_init_options": {"episode_id": episode_id}})
    adapter.reset()
    instruction = env.get_language_instruction()
    batches = []
    act_steps = int(cfg["act_steps"])
    truncated = False
    for _ in range(n_steps):
        ids, am, px, pr = _inputs(adapter.preprocess(env, obs, instruction), device)
        batches.append({"input_ids": ids, "attention_mask": am, "pixel_values": px,
                        "proprios": pr})
        rng, noise = _noise(rng, model, device)
        actions = model.infer_action(ids, am, px, pr, noise)
        for a in adapter.postprocess(actions[0].float().cpu().numpy())[:act_steps]:
            obs, _, _, truncated, _ = env.step(a)
            if truncated:
                break
        if truncated:
            break
    return batches


def build(yaml_name: str, quant, shared: dict, device):
    """(cfg, model, adapter) of one variant: the shared draw copied in, then
    quantized by the data-free tiers or by GPTQ."""
    gptq = quant is not None and "gptq" in str(quant)
    if gptq:
        # the pool64 yaml carries its w4a8 modes; the bridge row takes the
        # full-dims w4a8 recipe first
        cfg = variant_cfg(yaml_name, "w4a8" if yaml_name == "bridge.yaml" else None)
    else:
        cfg = variant_cfg(yaml_name, quant)
    model = PiZero(cfg, device=device, dtype=torch.bfloat16)
    model.load_state_dict(shared)
    model.eval()
    adapter = instantiate(cfg["env"]["adapter"])
    if gptq:
        from blurr_tpu_torch.models.pi0.calibrate import gptq_quantize_pi0

        batches = _calib_batches(model, adapter, cfg, device)
        gptq_quantize_pi0(model, batches, num_flow_steps=int(cfg["num_inference_steps"]))
        adapter.reset()
    else:
        model.enable_action_quantization()
        model.enable_vlm_quantization()
    return cfg, model, adapter


def rollout(cfg, model, adapter, device):
    """(end-effector trajectory [T, 8], first action chunk)."""
    env = FakeSimplerEnv()
    rng = prng.prng_key(SEED)
    traj, first_chunk = [], None
    act_steps = int(cfg["act_steps"])
    for ep in range(EPISODES):
        obs, _ = env.reset(options={"obj_init_options": {"episode_id": ep}})
        adapter.reset()
        instruction = env.get_language_instruction()
        truncated = False
        while not truncated:
            args = _inputs(adapter.preprocess(env, obs, instruction), device)
            rng, noise = _noise(rng, model, device)
            chunk = model.infer_action(*args, noise)[0].float().cpu().numpy()
            if first_chunk is None:
                first_chunk = chunk.copy()
            for a in adapter.postprocess(chunk)[:act_steps]:
                obs, _, _, truncated, _ = env.step(a)
                traj.append(obs["agent"]["eef_pos"].copy())
                if truncated:
                    break
    return np.array(traj), first_chunk


def _report(tag, ref, cur) -> str:
    t_ref, c_ref = ref
    t, c = cur
    n = min(len(t), len(t_ref))
    d = np.abs(t[:n] - t_ref[:n])
    line = (f"{tag:14s}: first-chunk action MAE {np.abs(c - c_ref).mean():.5f} "
            f"max {np.abs(c - c_ref).max():.5f} | eef divergence per-step "
            f"mean {d.mean():.6f} max {d.max():.6f} final {d[-1].max():.6f}")
    print(line, flush=True)
    return line


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Closed-loop quantization divergence of Pi-0 "
                                            "(PyTorch port).")
    p.add_argument("variants", nargs="*", help=f"a subset of {list(VARIANTS)} (default: all)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the variants; returns {tag: (trajectory, first chunk)} and the
    report lines under "report"."""
    args = parse_args(argv)
    only = set(args.variants)
    unknown = only - set(VARIANTS)
    if unknown:
        sys.exit(f"unknown variant(s) {sorted(unknown)}; choose from {list(VARIANTS)}")
    device = torch.device(args.device)
    run = only | {CONTROL[t] for t in only if t in CONTROL} if only else set(VARIANTS)
    results = {}
    shared = {}  # dims group -> the bf16 state dict of its one draw
    with torch.no_grad():
        for tag, (yaml_name, quant) in VARIANTS.items():
            if tag not in run:
                continue
            group = "bridge.yaml" if yaml_name == "bridge.yaml" else "pool64"
            if group not in shared:
                # free the previous group's draw before the next
                shared.clear()
                gc.collect()
                shared[group] = base_params(yaml_name, device)
                print(f"{group}: base params initialized", flush=True)
            cfg, model, adapter = build(yaml_name, quant, shared[group], device)
            results[tag] = rollout(cfg, model, adapter, device)
            print(f"{tag}: rolled {len(results[tag][0])} env steps", flush=True)
            del model
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    report = []
    full_ref = results.get("bf16")
    pool_ref = results.get("pool64_bf16")
    print("\n=== vs bf16 (full bridge.yaml dims) ===", flush=True)
    for tag in ("bf16_rerun", "w8a8", "w4a8", "w4a8_g128", "w4a8_mixed", "w4a8_g128_mixed",
                "w4a8_gptq", "int8kv"):
        if tag in results:
            report.append(_report(f"{tag} vs bf16", full_ref, results[tag]))
    if pool_ref is not None:
        print("\n=== vs pool64_bf16 (pool64 pad96 preset dims) ===", flush=True)
        for tag in ("pool64_w8a8", "pool64_w4a8", "pool64_w4a8_gptq"):
            if tag in results:
                report.append(_report(f"{tag} vs pool64_bf16", pool_ref, results[tag]))
    results["report"] = report
    return results


if __name__ == "__main__":
    main()
