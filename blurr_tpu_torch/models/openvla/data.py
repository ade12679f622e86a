"""Sharded datasets for OpenVLA fine-tuning.

Counterpart of ``blurr_tpu/models/openvla/data.py``. The streaming layer
(memory-mapped shards, the resumable shuffled loader, prefetch) is the
port's ``blurr_tpu_torch.data``; this module fixes the OpenVLA key
convention on it and assembles the trainer's host batches
(``scripts/train_openvla_lora_torch.py --data DIR``).

Keys (written by :func:`write_openvla_dataset`):

- ``image``           [N, H, W, 3] uint8 camera frames
- ``instruction_ids`` [N, T] int32 tokenized prompts (BOS ... the trailing
                      empty token, right-padded with 0)
- ``instruction_len`` [N] int32 prompt lengths
- ``action``          [N, action_dim] (the AR token objective) or
                      [N, chunk_len, action_dim] (OFT's L1), in [-1, 1]
- ``proprio``         [N, P] float32 (optional; OFT ``--use-proprio``)
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from blurr_tpu_torch.models.openvla.processing import process_image, tokenize_prompt_ids


def write_openvla_dataset(out_dir, images: np.ndarray, instructions: Sequence[str],
                          actions: np.ndarray, tokenizer=None,
                          proprios: Optional[np.ndarray] = None, max_text_tokens: int = 32,
                          shard_size: int = 1024) -> dict:
    """Tokenize and pack raw (image, instruction, action) triples into the
    sharded format; each distinct instruction is tokenized once. Returns
    the manifest."""
    from blurr_tpu_torch.data import write_dataset
    from blurr_tpu_torch.models.openvla.processing import StubLlamaTokenizer

    tokenizer = tokenizer or StubLlamaTokenizer()
    n = len(instructions)
    if images.shape[0] != n or actions.shape[0] != n:
        raise ValueError(f"{images.shape[0]} images and {actions.shape[0]} actions for "
                         f"{n} instructions")
    cache: Dict[str, list] = {}
    ids = np.zeros((n, max_text_tokens), np.int32)
    lens = np.zeros((n,), np.int32)
    for i, instr in enumerate(instructions):
        toks = cache.get(str(instr))
        if toks is None:
            toks = cache[str(instr)] = tokenize_prompt_ids(tokenizer, str(instr),
                                                           max_text_tokens)
        ids[i, :len(toks)] = toks
        lens[i] = len(toks)
    arrays = {
        "image": np.ascontiguousarray(images, np.uint8),
        "instruction_ids": ids,
        "instruction_len": lens,
        "action": np.asarray(actions, np.float32),
    }
    if proprios is not None:
        arrays["proprio"] = np.asarray(proprios, np.float32)
    return write_dataset(out_dir, arrays, shard_size=shard_size)


class OpenVLATrainTransform:
    """Loader transform: raw rows -> the trainer's host batch (numpy).

    AR (``oft=False``): each example's label tokens are appended right after
    its prompt (contiguous, the padding at the end), giving ``input_ids``,
    ``attn_valid``, ``pixel_values`` and ``labels`` for
    ``OpenVLA.action_ce_loss``. OFT: ``input_ids``, ``attn_valid``,
    ``pixel_values``, ``actions`` (and ``proprio``) for ``oft_l1_loss``, the
    ragged prompts riding ``attn_valid``."""

    def __init__(self, model, image_size: int, fused: bool, oft: bool = False,
                 use_proprio: bool = False):
        self.model = model
        self.image_size = int(image_size)
        self.fused = bool(fused)
        self.oft = bool(oft)
        self.use_proprio = bool(use_proprio)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        ids = np.array(batch["instruction_ids"], np.int32)
        lens = np.asarray(batch["instruction_len"], np.int32)
        b, t = ids.shape
        px = np.concatenate([process_image(img, self.image_size, self.fused)
                             for img in np.asarray(batch["image"])], axis=0)
        if self.oft:
            out = {
                "input_ids": ids,
                "attn_valid": (np.arange(t)[None, :] < lens[:, None]).astype(np.int32),
                "pixel_values": px,
                "actions": np.asarray(batch["action"], np.float32),
            }
            if self.use_proprio:
                out["proprio"] = np.asarray(batch["proprio"], np.float32)
            return out
        action_dim = batch["action"].shape[-1]
        labels = self.model.tokenize_actions(batch["action"])
        full = np.zeros((b, t + action_dim), np.int32)
        full[:, :t] = ids
        for r in range(b):  # the labels start at each prompt's length
            full[r, lens[r]:lens[r] + action_dim] = labels[r]
        valid = np.arange(t + action_dim)[None, :] < (lens + action_dim)[:, None]
        return {
            "input_ids": full,
            "attn_valid": valid.astype(np.int32),
            "pixel_values": px,
            "labels": labels,
        }
