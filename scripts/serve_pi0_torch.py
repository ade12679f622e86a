#!/usr/bin/env python3
"""Run the Pi-0 action server of the PyTorch port (blurr_tpu_torch).

    python scripts/serve_pi0_torch.py \\
        --config config/eval/bridge.yaml --preset blurr --port 8787

The port's counterpart of scripts/serve_pi0.py, on the single-request path.
It serves on the card (--device, default cuda); --device cpu runs the plain
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
    return p.parse_args(argv)


def main(argv=None):
    from blurr_tpu_torch.presets import apply_preset, load_config

    args = parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    from blurr_tpu_torch.serving.server import ActionServer

    cfg = load_config(args.config)
    apply_preset(cfg, args.preset)
    server = ActionServer(cfg, args.checkpoint, device=args.device,
                          seed=args.seed)
    logging.info("warmup took %.1f s", server.warmup())
    server.serve_forever(args.host, args.port)


if __name__ == "__main__":
    main()
