#!/usr/bin/env python3
"""Run the Pi-0 action server of the PyTorch port (blurr_tpu_torch).

    python scripts/serve_pi0_torch.py \\
        --config config/eval/bridge.yaml --preset blurr --port 8787

The port's counterpart of scripts/serve_pi0.py, with its flags. It serves on the card (--device, default cuda); --device cpu runs the plain
versions of the kernels. With no card and no --device cpu it fails on its
first CUDA call: nothing falls back to the CPU. Clients: the port's
blurr_tpu_torch.serving.client.ActionClient, or the JAX package's
blurr_tpu.serving.ActionClient (the same wire bytes):
.predict(image_u8_hw3, instruction, proprio) -> raw normalized action chunk
[horizon, action_dim]; an image
that is not image_size square (224x224 for bridge.yaml) is resized with the
Lanczos ladder of blurr_tpu_torch/utils/image.py. --checkpoint random
(the default) draws random weights on the device from --seed; a path loads
a reference .pt checkpoint ({"model": state_dict}, as
blurr_tpu_torch.models.pi0.checkpoint.save_torch_checkpoint writes) onto
the device in the model dtype. The weights are then quantized there as the
config says: e.g. --config config/eval/bridge_pool64_steps2.yaml serves the
int8 tier (action expert int8 or its cached bf16 copy, int8 KV cache). As
in scripts/serve_pi0.py, --preset (default blurr) is applied on top of the
config, so its num_inference_steps wins; --preset baseline (or vanilla)
serves the naive step (no prefix cache, fp32, 10 flow steps). Joint
attention runs through the port's CUDA flash kernel only when the config
sets joint.config.use_flash_attn.

--max-batch N > 1 turns on dynamic batching: requests that arrive within
--batch-window-ms of each other are padded to the next power-of-2 bucket
(--bucket-mode max: always N) and served by one step; --max-queue M > 0
rejects a request with an "Overloaded" error while M wait unclaimed. The
startup warmup runs every bucket. --tp N shards the weights over N ranks
(tensor parallelism), --dp N splits each dynamic batch over N ranks (data
parallelism; a power of 2 with --max-batch >= N); the two compose on a (dp,
tp) mesh of dp x tp ranks, one process each, this one rank 0
(blurr_tpu_torch/parallel/mesh.py: gloo on the CPU or where ranks share a
card, nccl where each has its own). On the CPU: --device cpu --tp 2; on the
one card, the same without --device cpu (two ranks then share cuda:0 over
gloo). scripts/serve_ctl_torch.py reads a running
server's stats and hot-reloads its weights.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def parse_args(argv=None) -> argparse.Namespace:
    from blurr_tpu_torch.presets import ALIASES, PRESETS

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default="config/eval/bridge.yaml")
    p.add_argument("--checkpoint", type=str, default="random",
                   help="random (weights drawn from --seed) or the path of a "
                        "reference .pt checkpoint")
    p.add_argument("--preset", type=str, default="blurr",
                   choices=sorted({*PRESETS, *ALIASES}))
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on: cuda (default), cuda:1, "
                        "or cpu (the plain versions of the kernels)")
    p.add_argument("--max-batch", type=int, default=1,
                   help="dynamic batching: requests arriving within --batch-window-ms "
                        "are padded to a bucket and served by one step")
    p.add_argument("--batch-window-ms", type=float, default=2.0)
    p.add_argument("--bucket-mode", type=str, default="pow2", choices=["pow2", "max"],
                   help="pow2: the next power-of-2 bucket; max: every batch padded "
                        "to --max-batch (one shape)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="backpressure: reject a request while this many wait "
                        "unclaimed (0 admits everything)")
    p.add_argument("--tp", type=int, default=1,
                   help="Tensor-parallel serving over a (1, tp) mesh of ranks "
                        "(capacity path: per-card weight bytes divided by tp; "
                        "heads/MLP split per blurr_tpu_torch/parallel/mesh.py).")
    p.add_argument("--dp", type=int, default=1,
                   help="Data-parallel serving over the 'data' ranks "
                        "(throughput path: each dynamic batch splits over dp "
                        "ranks; power of 2, requires --max-batch >= dp; "
                        "composes with --tp on a (dp, tp) mesh).")
    return p.parse_args(argv)


def build_server(args):
    from blurr_tpu_torch.presets import apply_preset, load_config
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config(args.config)
    apply_preset(cfg, args.preset)
    return ActionServer(cfg, args.checkpoint, device=args.device, seed=args.seed,
                        max_batch=args.max_batch, batch_window_ms=args.batch_window_ms,
                        tp=args.tp, dp=args.dp, max_queue=args.max_queue,
                        bucket_mode=args.bucket_mode)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    server = build_server(args)
    logging.info("warmup took %.1f s", server.warmup())
    server.serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
