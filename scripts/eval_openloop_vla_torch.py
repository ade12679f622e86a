#!/usr/bin/env python3
"""Open-loop action evaluation of the OpenVLA family with the PyTorch port
(blurr_tpu_torch).

    python scripts/eval_openloop_vla_torch.py --model-id random-7b \\
        --checkpoint out/params --data DIR --examples 64

The port's counterpart of scripts/eval_openloop_vla.py, with its flags,
metrics and exits plus --device (default cuda; --device cpu runs the plain
versions of the kernels). It scores any build_openvla model (AR, OFT,
MiniVLA; bf16 / fp32, w8a8 / w4a8; --checkpoint a trainer --save-params
tree) on the LAST --examples rows of a dataset in the trainer's sharded
format (blurr_tpu_torch/models/openvla/data.py's keys) or of 'synthetic',
through the serving entry points: the ragged greedy decode
(predict_action_tokens_ragged) or OFT's continuous chunk
(predict_action_continuous), in fixed batches of --batch-size (the last
padded, its pad rows left out of the metrics).

Metrics, in the normalized [-1, 1] action space: AR: action MSE / MAE,
token accuracy (the predicted action tokens against the labels' tokens)
and gripper sign agreement; OFT: chunk L1 (the training loss), MSE / MAE,
the MSE of the first --act-steps rows and gripper agreement. The last line
of the output is the metrics as JSON (JAX's keys). Greedy decoding draws
nothing, so a rerun gives the same numbers. --dp > 1 is refused (ROADMAP
M14).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Open-loop action error for OpenVLA-family "
                                            "checkpoints (PyTorch port).")
    p.add_argument("--model-id", type=str, default="random",
                   help="HF snapshot dir or a checkpoint-free id (random / random-7b / "
                        "random-minivla / ...)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="train_openvla_lora_torch.py --save-params directory; --model-id "
                        "supplies the spec")
    p.add_argument("--data", type=str, default="synthetic",
                   help="sharded OpenVLA dataset dir (write_openvla_dataset keys) or "
                        "'synthetic'")
    p.add_argument("--examples", type=int, default=64,
                   help="evaluation window: the LAST N dataset examples")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--quantization", type=str, default="none", choices=["none", "w8a8", "w4a8"])
    p.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--max-text-tokens", type=int, default=32)
    p.add_argument("--oft", action="store_true",
                   help="OFT's continuous chunk (dataset actions [N, chunk_len, action_dim])")
    p.add_argument("--chunk-len", type=int, default=8)
    p.add_argument("--use-proprio", action="store_true")
    p.add_argument("--proprio-dim", type=int, default=8)
    p.add_argument("--act-steps", type=int, default=4,
                   help="executed-prefix rows for the OFT prefix metric")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output-json", type=str, default="")
    p.add_argument("--dp", type=int, default=1, help="not ported (ROADMAP M14)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p.parse_args(argv)


def load_examples(args, spec, tokenizer) -> dict:
    """instruction_ids [N, T], instruction_len [N], image [N, H, W, 3] uint8,
    action (and proprio): the LAST --examples rows."""
    from blurr_tpu_torch.models.openvla.processing import StubLlamaTokenizer, tokenize_prompt_ids

    if args.data != "synthetic":
        from blurr_tpu_torch.data import ShardedDataset

        ds = ShardedDataset(args.data)
        n = min(args.examples, ds.num_examples)
        data = ds.gather_batch(np.arange(ds.num_examples - n, ds.num_examples))
        missing = [k for k in ("image", "instruction_ids", "instruction_len", "action")
                   if k not in data]
        if missing:
            sys.exit(f"dataset is missing keys {missing}; has {sorted(data)}")
        return data

    sys.path.insert(0, str(REPO_ROOT / "scripts"))
    from train_openvla_lora_torch import synthetic_examples

    n = args.examples
    action_shape = (args.chunk_len, spec.action_dim) if args.oft else (spec.action_dim,)
    raw = synthetic_examples(n, spec.siglip.image_size, action_shape, args.seed + 13,
                             proprio_dim=args.proprio_dim if args.use_proprio else 0)
    tok = tokenizer or StubLlamaTokenizer()
    ids = np.zeros((n, args.max_text_tokens), np.int32)
    lens = np.zeros((n,), np.int32)
    cache = {}
    for i, instr in enumerate(raw["instructions"]):
        if instr not in cache:
            cache[instr] = tokenize_prompt_ids(tok, instr, args.max_text_tokens)
        t = cache[instr]
        ids[i, :len(t)] = t
        lens[i] = len(t)
    out = {"image": raw["images"], "instruction_ids": ids, "instruction_len": lens,
           "action": raw["actions"]}
    if args.use_proprio:
        out["proprio"] = raw["proprios"]
    return out


def main(argv=None) -> dict:
    """Evaluate as the flags say; returns the metrics."""
    args = parse_args(argv)
    if args.dp > 1:
        sys.exit(f"--dp {args.dp}: data-parallel evaluation is not ported to the PyTorch "
                 "port yet (ROADMAP M14)")
    import torch

    from blurr_tpu_torch.models.openvla.build import build_openvla
    from blurr_tpu_torch.models.openvla.processing import process_image

    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    try:
        built = build_openvla(args.model_id, device=device, dtype=dtype, oft=args.oft,
                              chunk_len=args.chunk_len, use_proprio=args.use_proprio,
                              proprio_dim=args.proprio_dim, quantization=args.quantization,
                              memory_safe_quant_init=True, seed=args.seed,
                              checkpoint_path=args.checkpoint or None)
    except ValueError as exc:
        sys.exit(str(exc))
    model, spec = built.model, built.spec

    data = load_examples(args, spec, built.tokenizer)
    # the rank and shape must fit the variant before any metric: a wrong
    # dataset would broadcast into wrong numbers
    a_shape = data["action"].shape
    if args.oft:
        if len(a_shape) != 3 or a_shape[1:] != (args.chunk_len, spec.action_dim):
            sys.exit(f"--oft expects actions [N, {args.chunk_len}, {spec.action_dim}] "
                     f"(chunk_len x action_dim); dataset has {list(a_shape)}. Match "
                     "--chunk-len to the dataset or drop --oft for a single-step (AR) dataset.")
    elif len(a_shape) != 2 or a_shape[1] != spec.action_dim:
        sys.exit(f"AR eval expects actions [N, {spec.action_dim}]; dataset has "
                 f"{list(a_shape)}. Pass --oft for chunked datasets.")
    n = a_shape[0]
    bs = args.batch_size

    se = ae = se_prefix = 0.0
    grip_match = grip_total = tok_match = tok_total = count = count_prefix = 0
    k = min(args.act_steps, args.chunk_len) if args.oft else 0
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        live = hi - lo
        rows = {kk: v[lo:hi] for kk, v in data.items()}
        if live < bs:  # padded to the fixed batch; the pad rows are left out
            rows = {kk: np.concatenate([v] + [v[-1:]] * (bs - live)) for kk, v in rows.items()}
        px = np.concatenate([process_image(img, spec.siglip.image_size, spec.use_fused_vision)
                             for img in rows["image"]], axis=0)
        t = rows["instruction_ids"].shape[1]
        valid = (np.arange(t)[None, :] < rows["instruction_len"][:, None]).astype(np.int32)
        ids = torch.from_numpy(np.ascontiguousarray(rows["instruction_ids"])).to(device)
        valid = torch.from_numpy(valid).to(device)
        px = torch.from_numpy(px).to(device, dtype)
        if args.oft:
            proprio = (torch.from_numpy(np.asarray(rows["proprio"], np.float32)).to(device, dtype)
                       if args.use_proprio else None)
            out = model.predict_action_continuous(ids, px, proprio, attn_valid=valid)
            out = out.float().cpu().numpy()[:live]
        else:
            out = model.predict_action_tokens_ragged(ids, px, valid).cpu().numpy()[:live]
        gt = np.asarray(rows["action"], np.float64)[:live]
        if args.oft:
            pred = out.astype(np.float64)  # [B, chunk, dim]
        else:
            gt_tokens = model.tokenize_actions(gt)  # the training objective's labels
            tok_match += int((out == gt_tokens).sum())
            tok_total += out.size
            pred = model.detokenize_actions(out).astype(np.float64)
        err = pred - gt
        se += float((err ** 2).sum())
        ae += float(np.abs(err).sum())
        if args.oft:
            se_prefix += float((err[:, :k] ** 2).sum())
            count_prefix += live * k * gt.shape[-1]
        grip_match += int((np.sign(pred[..., -1]) == np.sign(gt[..., -1])).sum())
        grip_total += int(np.prod(gt[..., -1].shape))
        count += int(np.prod(gt.shape))

    metrics = {
        "examples": n,
        "variant": "oft" if args.oft else "ar",
        "mse": se / count,
        "mae": ae / count,
        "gripper_agreement": grip_match / grip_total,
        "model_id": args.model_id,
        "checkpoint": args.checkpoint,
        "quantization": args.quantization,
        "seed": args.seed,
    }
    if args.oft:
        # the mean |err| over the chunk is the OFT training loss
        metrics["l1"] = metrics["mae"]
        metrics["mse_prefix"] = se_prefix / count_prefix
        metrics["act_steps"] = k
    else:
        metrics["token_accuracy"] = tok_match / tok_total

    print(f"Open-loop VLA eval ({metrics['variant']}): {n} examples")
    print(f"  action MSE:          {metrics['mse']:.6f}")
    print(f"  action MAE:          {metrics['mae']:.6f}")
    if args.oft:
        print(f"  chunk L1:            {metrics['l1']:.6f}")
        print(f"  prefix MSE:          {metrics['mse_prefix']:.6f}")
    else:
        print(f"  token accuracy:      {metrics['token_accuracy']:.4f}")
    print(f"  gripper agreement:   {metrics['gripper_agreement']:.4f}")
    print(json.dumps(metrics), flush=True)
    if args.output_json:
        Path(args.output_json).parent.mkdir(parents=True, exist_ok=True)
        with open(args.output_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
