#!/usr/bin/env python3
"""Greedy PaliGemma text generation on the PyTorch port.

    python scripts/demo_paligemma_text_torch.py [--fused] [--device cpu]

The counterpart of ``scripts/demo_paligemma_text.py``, with its flags and
``--device`` (default ``cuda``; ``cpu`` runs the plain versions). With
``--model-path DIR`` (an HF PaliGemma snapshot: ``config.json``, the
safetensors shards and the tokenizer, which needs ``transformers``) it
captions ``--image`` (default: random pixels) after ``--prompt``; with the
default ``random`` it runs a tiny random model (2 layers, widths of 32,
vocab 300, a 28-pixel image) on a random prompt and prints the token ids.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

# the random mode's tiny model (the JAX demo's)
TINY_CONFIG = dict(
    vision_config={
        "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "image_size": 28, "patch_size": 14,
    },
    text_config={
        "vocab_size": 300, "hidden_size": 32, "intermediate_size": 64,
        "num_hidden_layers": 2, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 16,
    },
    image_token_index=260,
    pad_token_id=0,
    projection_dim=32,
    hidden_size=32,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-path", type=str, default="random",
                   help="PaliGemma HF snapshot dir, or 'random' (tiny smoke).")
    p.add_argument("--image", type=str, default="")
    p.add_argument("--prompt", type=str, default="this image shows ")
    p.add_argument("--max-new-tokens", type=int, default=20)
    p.add_argument("--use-bf16", action="store_true")
    p.add_argument("--fused", action="store_true",
                   help="Generate on the device with one copy to the host at the end.")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device ('cuda', 'cuda:1', 'cpu').")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
    from blurr_tpu_torch.models.paligemma.model import PaliGemmaForConditionalGeneration

    dtype = torch.bfloat16 if args.use_bf16 else torch.float32
    device = torch.device(args.device)
    snapshot = Path(args.model_path).is_dir()

    if snapshot:
        from PIL import Image
        from transformers import AutoTokenizer

        from blurr_tpu_torch.models.paligemma.load import load_hf_model
        from blurr_tpu_torch.models.paligemma.processing import PaliGemmaProcessor

        model = load_hf_model(args.model_path, dtype, device)
        tokenizer = AutoTokenizer.from_pretrained(args.model_path, padding_side="right")
        vc = model.config.vision_config
        processor = PaliGemmaProcessor(tokenizer, vc.num_image_tokens, vc.image_size)
        if args.image and Path(args.image).exists():
            image = Image.open(args.image).convert("RGB")
        else:
            image = Image.fromarray(
                np.random.RandomState(0).randint(0, 256, (224, 224, 3), np.uint8)
            )
        inputs = processor(text=[args.prompt], images=[image])
        eos = tokenizer.eos_token_id
    else:
        config = PaliGemmaConfig(**TINY_CONFIG)
        model = PaliGemmaForConditionalGeneration(config, device=device, dtype=dtype)
        model.init_params(torch.Generator(device).manual_seed(0))
        rng = np.random.RandomState(0)
        n_img = config.vision_config.num_image_tokens
        ids = np.concatenate(
            [np.full((1, n_img), config.image_token_index, np.int32),
             rng.randint(3, 299, (1, 6))], axis=1
        )
        inputs = {"input_ids": ids,
                  "pixel_values": rng.rand(1, 3, 28, 28).astype(np.float32)}
        eos = None

    gen = model.generate_fused if args.fused else model.generate
    toks = gen(inputs["input_ids"], inputs["pixel_values"],
               max_new_tokens=args.max_new_tokens, eos_token_id=eos)
    print("\n=========================")
    print("Prompt:", args.prompt)
    if snapshot:
        print("Generated text:", tokenizer.decode(toks[0], skip_special_tokens=True))
    else:
        print("Generated token ids:", toks[0].tolist())
    print("=========================\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
