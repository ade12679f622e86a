"""VLA input processing: prompt tokenization (numpy) and image
normalization (on the device).

Counterpart of ``blurr_tpu/models/pi0/processing.py`` (``StubTokenizer``,
``setup_paligemma_tokenizer``, ``VLAProcessor``, ``process_images``), which
imports ``jax.numpy`` and so cannot be shared, and of
``blurr_tpu/benchmarks.py:build_processor``. Tokenization stays on the host
in numpy; the prompt is the PaliGemma format ``<image>*N + BOS + text +
"\\n"``, padded to ``max_seq_len``, with the image tokens always first.
``build_processor`` takes the PaliGemma tokenizer from the config's local
``pretrained_model_path`` when ``transformers`` and the files are there,
else the stub.
"""

from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)

IMAGENET_STANDARD_MEAN = 0.5
IMAGENET_STANDARD_STD = 0.5


def add_image_tokens_to_prompt(
    prefix_prompt: str, bos_token: str, image_seq_len: int, image_token: str
) -> str:
    return f"{image_token * image_seq_len}{bos_token}{prefix_prompt}\n"


def process_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, 3, H, W] -> float32 ``(x / 255 - 0.5) / 0.5``, on the
    images' device."""
    x = images.float()
    return (x / 255.0 - IMAGENET_STANDARD_MEAN) / IMAGENET_STANDARD_STD


class StubTokenizer:
    """Dependency-free tokenizer without the real PaliGemma vocabulary: it
    hashes words into ids below ``vocab_size`` (the same ids as the JAX
    package's stub within one process) and honours the special-token
    surface ``VLAProcessor`` uses."""

    def __init__(self, vocab_size: int = 1000, image_token_id: int = 257152):
        self.vocab_size = vocab_size
        self._image_token_id = image_token_id
        self.bos_token = "<bos>"
        self.bos_token_id = 2
        self.eos_token_id = 1
        self.pad_token_id = 0

    def add_special_tokens(self, tokens) -> None:
        pass

    def add_tokens(self, tokens) -> None:
        pass

    def convert_tokens_to_ids(self, tok: str) -> int:
        if tok == "<image>":
            return self._image_token_id
        return self._word_id(tok)

    def _word_id(self, word: str) -> int:
        return abs(hash(word)) % (self.vocab_size - 3) + 3

    def __call__(self, texts: Sequence[str], return_tensors="np", max_length=None,
                 padding="max_length", truncation=True) -> dict:
        img_tok = "<image>"
        rows, masks = [], []
        for t in texts:
            n_img = 0
            while t.startswith(img_tok):
                n_img += 1
                t = t[len(img_tok):]
            ids = [self._image_token_id] * n_img
            if t.startswith(self.bos_token):
                t = t[len(self.bos_token):]
                ids.append(self.bos_token_id)
            ids += [self._word_id(w) for w in t.split()]
            ids.append(self._word_id("\n"))
            if truncation and max_length:
                ids = ids[:max_length]
            mask = [1] * len(ids)
            if padding == "max_length" and max_length:
                pad = max_length - len(ids)
                ids += [self.pad_token_id] * pad
                mask += [0] * pad
            rows.append(ids)
            masks.append(mask)
        return {
            "input_ids": np.array(rows, np.int32),
            "attention_mask": np.array(masks, np.int32),
        }


def setup_paligemma_tokenizer(tokenizer, image_token: str) -> int:
    """Add the ``<image>`` special token and the ``<loc####>`` /
    ``<seg###>`` tokens, turn off the tokenizer's own BOS and EOS (the
    prompt carries BOS); returns the image token's id."""
    tokenizer.add_special_tokens({"additional_special_tokens": [image_token]})
    extra = [f"<loc{i:04d}>" for i in range(1024)]
    extra += [f"<seg{i:03d}>" for i in range(128)]
    tokenizer.add_tokens(extra)
    tokenizer.add_bos_token = False
    tokenizer.add_eos_token = False
    return tokenizer.convert_tokens_to_ids(image_token)


class VLAProcessor:
    """Prompt processor for PaliGemma-format VLAs: ``num_image_tokens``
    image tokens first, then BOS, the instruction and a newline, padded to
    ``max_seq_len``."""

    IMAGE_TOKEN = "<image>"

    def __init__(self, tokenizer, num_image_tokens: int, max_seq_len: int,
                 tokenizer_padding: str = "max_length"):
        self.tokenizer = tokenizer
        self.image_seq_length = num_image_tokens
        self.max_seq_len = max_seq_len
        self.tokenizer_padding = tokenizer_padding
        self.image_token_id = setup_paligemma_tokenizer(tokenizer, self.IMAGE_TOKEN)

    def tokenize(self, text: List[str], truncation: bool = True) -> dict:
        """-> numpy int32 ``input_ids`` and ``attention_mask`` [B, max_seq_len]."""
        prompts = [
            add_image_tokens_to_prompt(
                t, self.tokenizer.bos_token, self.image_seq_length,
                self.IMAGE_TOKEN,
            )
            for t in text
        ]
        out = self.tokenizer(
            prompts, return_tensors="np", max_length=self.max_seq_len,
            padding=self.tokenizer_padding, truncation=truncation,
        )
        return {k: np.asarray(out[k], np.int32) for k in ("input_ids", "attention_mask")}

    def __call__(self, text: List[str], images, truncation: bool = True) -> dict:
        """Prompts and uint8 images [B, 3, H, W] -> host tensors: int64
        ``input_ids``, int32 ``attention_mask`` [B, max_seq_len] and fp32
        ``pixel_values`` (``process_images``)."""
        images = np.asarray(images)
        if len(images) != len(text):
            raise ValueError(f"Received {len(images)} images for {len(text)} prompts.")
        if images.dtype != np.uint8:
            raise ValueError(f"Expected uint8 images, got {images.dtype}.")
        out = self.tokenize(text, truncation=truncation)
        return {
            "pixel_values": process_images(torch.from_numpy(images)),
            "input_ids": torch.from_numpy(out["input_ids"]).long(),
            "attention_mask": torch.from_numpy(out["attention_mask"]),
        }


def _tokenizer(cfg):
    """The PaliGemma tokenizer from the local ``pretrained_model_path``, or
    the stub, with one warning that says why: a real checkpoint served on
    the stub's ids reads meaningless instructions."""
    path = cfg.get("pretrained_model_path")
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(
            path, padding_side=cfg.get("tokenizer_padding_side", "right"),
            local_files_only=True,
        )
    except Exception as exc:  # no transformers, no files: the stub, as JAX does
        log.warning(
            "no PaliGemma tokenizer at pretrained_model_path=%r (%s: %s); "
            "using the stub tokenizer, whose ids mean nothing to a real "
            "checkpoint", path, type(exc).__name__, exc,
        )
        return StubTokenizer(image_token_id=cfg["image_token_index"])


def build_processor(cfg) -> VLAProcessor:
    """The processor of a Pi-0 config (JAX ``benchmarks.build_processor``)."""
    return VLAProcessor(
        _tokenizer(cfg),
        cfg["vision"]["config"]["num_image_tokens"],
        cfg["max_seq_len"],
        tokenizer_padding=cfg.get("tokenizer_padding", "max_length"),
    )
