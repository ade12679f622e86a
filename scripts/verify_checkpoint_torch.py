#!/usr/bin/env python3
"""Check a checkpoint against a config with the PyTorch port
(blurr_tpu_torch) BEFORE running evals.

    python scripts/verify_checkpoint_torch.py --checkpoint pi0.pt --kind pi0 \\
        --config config/eval/bridge.yaml

The port's counterpart of scripts/verify_checkpoint.py. It holds the
tensors of a Pi-0 reference .pt, a PaliGemma safetensors directory or an
OpenVLA HF snapshot against the key map that the port's loader for that
kind walks (blurr_tpu_torch/models/pi0/checkpoint.py:reference_state_dict,
paligemma_state_dict; models/openvla/checkpoint.py:openvla_hf_state_dict),
on the model the config gives (--kind pi0: --config; paligemma: the
directory's config.json; openvla: OpenVLA-7B's widths), built on the meta
device so no weight is drawn and no file tensor is read. A layer's keys
are counted as one leaf over the layers, as the JAX package stacks them,
so the report has the JAX script's leaves, sections and counts (under the
file's key names). Keys the loader does not read are ignored, unless they
sit beside a tensor it reads (UNEXPECTED). It exits 1 on any problem,
else 0. Nothing runs on a card. --parity needs the reference
implementation's source tree, which is not in this repository, and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

_LAYER = re.compile(r"^(.*\.(?:layers|blocks)\.)(\d+)\.(.+)$")


def leaves(shapes: Dict[str, tuple]) -> Dict[str, object]:
    """{key: shape} -> {leaf: shape}: the keys of layer i (``...layers.{i}.``
    or ``...blocks.{i}.``) join one leaf ``...layers.*.`` whose shape is the
    layer count before the layer's shape, as JAX stacks them. Layers that
    are not 0 .. n-1, or of unequal shapes, give the leaf a description in
    place of a shape, which no expected shape equals."""
    out, per = {}, {}
    for key, shape in shapes.items():
        m = _LAYER.match(key)
        if m:
            per.setdefault(f"{m[1]}*.{m[3]}", {})[int(m[2])] = shape
        else:
            out[key] = shape
    for leaf, by in per.items():
        idxs, kinds = sorted(by), sorted(set(by.values()))
        if idxs == list(range(len(idxs))) and len(kinds) == 1:
            out[leaf] = (len(idxs), *kinds[0])
        else:
            out[leaf] = f"{len(idxs)} layers {idxs[0]}..{idxs[-1]} of shapes {kinds}"
    return out


def shapes(kind: str, checkpoint: str, config: str):
    """({key: shape} the port's loader reads, {key: shape} in the file)."""
    import torch

    def of(state):
        return {k: tuple(v.shape) for k, v in state.items()}

    if kind == "pi0":
        from blurr_tpu_torch.models.pi0.checkpoint import (
            load_torch_state_dict,
            reference_state_dict,
        )
        from blurr_tpu_torch.models.pi0.pizero import PiZero
        from blurr_tpu_torch.presets import load_config

        model = PiZero(load_config(config), device="meta", dtype=torch.float32)
        return of(reference_state_dict(model)), of(load_torch_state_dict(checkpoint))
    from blurr_tpu_torch.models.pi0.checkpoint import load_safetensors_dir

    if kind == "paligemma":
        from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
        from blurr_tpu_torch.models.paligemma.model import PaliGemmaForConditionalGeneration
        from blurr_tpu_torch.models.pi0.checkpoint import paligemma_state_dict

        with open(os.path.join(checkpoint, "config.json")) as f:
            model = PaliGemmaForConditionalGeneration(PaliGemmaConfig(**json.load(f)),
                                                      device="meta")
        expected = paligemma_state_dict(model.embed_tokens, model.vision_tower,
                                        model.multi_modal_projector, model.vlm)
        return of(expected), of(load_safetensors_dir(checkpoint))
    from blurr_tpu_torch.models.openvla.checkpoint import openvla_hf_state_dict
    from blurr_tpu_torch.models.openvla.model import OpenVLA, OpenVLASpec

    model = OpenVLA(OpenVLASpec(), device="meta", dtype=torch.float32)
    found = of(load_safetensors_dir(checkpoint))
    # the blocks a tower never runs, which the loader does not read
    for vit, prefix in ((model.dinov2, "vision_backbone.featurizer."),
                        (model.siglip, "vision_backbone.fused_featurizer.")):
        rx = re.compile(re.escape(prefix) + r"blocks\.(\d+)\.")
        found = {k: v for k, v in found.items()
                 if not ((m := rx.match(k)) and int(m[1]) >= len(vit.blocks))}
    return of(openvla_hf_state_dict(model)), found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", type=str, required=True,
                   help=".pt file, PaliGemma safetensors dir, or OpenVLA HF dir.")
    p.add_argument("--kind", type=str, default="pi0", choices=["pi0", "paligemma", "openvla"])
    p.add_argument("--config", type=str, default="config/eval/bridge.yaml",
                   help="Config defining the expected shapes (pi0 kind).")
    p.add_argument("--parity", action="store_true",
                   help="pi0 kind: also compare actions against the reference "
                        "implementation; needs its source tree, which is not in this "
                        "repository (exits 2).")
    p.add_argument("--parity-tol", type=float, default=1e-2,
                   help="Max |action| deviation tolerated by --parity.")
    args = p.parse_args(argv)

    expected, found = (leaves(d) for d in shapes(args.kind, args.checkpoint, args.config))
    beside = {leaf.rsplit(".", 1)[0] for leaf in expected}
    loaded = {leaf: shape for leaf, shape in found.items()
              if leaf in expected or leaf.rsplit(".", 1)[0] in beside}
    missing = sorted(set(expected) - set(loaded))
    unexpected = sorted(set(loaded) - set(expected))
    mismatched = sorted(k for k in set(expected) & set(loaded)
                        if expected[k] != loaded[k])

    errors = 0
    print(f"expected leaves: {len(expected)}  loaded leaves: {len(loaded)}")
    for label, items in (("MISSING", missing), ("UNEXPECTED", unexpected),
                         ("SHAPE MISMATCH", mismatched)):
        if items:
            errors += len(items)
            print(f"\n{label} ({len(items)}):")
            for k in items[:40]:
                exp = expected.get(k, "-")
                got = loaded.get(k, "-")
                print(f"  {k}: expected {exp}, got {got}")
    if errors:
        print(f"\n{errors} problems found.")
        return 1
    print("\nOK: checkpoint matches the config's parameter tree exactly.")

    if args.parity:
        if args.kind != "pi0":
            print("--parity currently supports kind=pi0 only.")
        else:
            print("reference tree not available; cannot run --parity.")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
