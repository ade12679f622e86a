#!/usr/bin/env python3
"""Export a Pi-0 parameter tree of the PyTorch port to a reference ``.pt``.

    python scripts/export_torch_checkpoint_torch.py \\
        --config config/eval/bridge.yaml --params runs/ft --out /tmp/bridge_ft.pt

The port's counterpart of scripts/export_torch_checkpoint.py: --params is a
directory that scripts/train_pi0_flow_torch.py --save-dir wrote (or
'random' for random weights drawn from --seed); the output is
``{"model": state_dict}`` with the reference's keys and fp32 tensors, as
blurr_tpu_torch.models.pi0.checkpoint.save_torch_checkpoint writes it, which
load_checkpoint and the reference load. Adapters on fp weights are merged
first; a QLoRA tree (quantized base weights) has no fp weights to write
and is refused. Loads on the card (--device, default cuda; --device cpu
on the host).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

log = logging.getLogger("export_torch_checkpoint")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default="config/eval/bridge.yaml")
    p.add_argument("--params", type=str, required=True,
                   help="a --save-dir directory, or 'random'")
    p.add_argument("--out", type=str, required=True, help="output .pt path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    import torch

    from blurr_tpu_torch.models.pi0.checkpoint import restore_params, save_torch_checkpoint
    from blurr_tpu_torch.models.pi0.pizero import PiZero
    from blurr_tpu_torch.ops.lora import merge_lora_tree
    from blurr_tpu_torch.presets import load_config

    device = torch.device(args.device)
    model = PiZero(load_config(args.config), device=device, dtype=torch.float32)
    if str(args.params).lower() == "random":
        model.init_params(torch.Generator(device=device).manual_seed(args.seed))
    else:
        restore_params(model, args.params)
        n = merge_lora_tree(model)
        if n:
            log.info("merged %d LoRA adapters into their fp weights", n)
    save_torch_checkpoint(model, args.out)
    log.info("wrote %s", args.out)


if __name__ == "__main__":
    main()
