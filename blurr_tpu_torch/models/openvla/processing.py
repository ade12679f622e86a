"""OpenVLA input processing: the prompt and the dual-normalized image stack.

Counterpart of ``blurr_tpu/models/openvla/processing.py``, whose constants
and prompt format the port keeps its own copy of. The prompt is
"In: What action should the robot take to {instruction}?\\nOut:", tokenized
by a LLaMA tokenizer with the trailing empty token 29871 appended. The image
is resized to the tower's size with the Lanczos ladder
(``utils/image.lanczos_resize_uint8``) and normalized twice, DINOv2's
ImageNet statistics in the first three channels and SigLIP's 0.5 / 0.5 in
the last three; a SigLIP-only model takes the last three alone. Both stay
on the host in numpy, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from blurr_tpu_torch.utils.image import lanczos_resize_uint8

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
SIGLIP_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
SIGLIP_STD = np.array([0.5, 0.5, 0.5], np.float32)

EMPTY_TOKEN = 29871  # LLaMA's "▁": the remote code appends it before decoding


def build_prompt(instruction: str) -> str:
    return f"In: What action should the robot take to {instruction.lower()}?\nOut:"


def tokenize_prompt_ids(tokenizer, instruction: str, max_text_tokens: int = 0) -> list:
    """BOS, the prompt and the trailing empty token, as a list of ids.
    ``max_text_tokens`` > 0 is a budget: a longer prompt raises ValueError."""
    out = tokenizer(build_prompt(str(instruction)), return_tensors="np")
    ids = np.asarray(out["input_ids"])[0].tolist()
    if ids[-1] != EMPTY_TOKEN:
        ids.append(EMPTY_TOKEN)
    if max_text_tokens and len(ids) > max_text_tokens:
        raise ValueError(
            f"instruction {instruction!r} tokenizes to {len(ids)} tokens "
            f"> max_text_tokens={max_text_tokens}"
        )
    return ids


def process_image(image: np.ndarray, image_size: int = 224, fused: bool = True) -> np.ndarray:
    """uint8 HxWx3 -> float32 [1, 6 (or 3), S, S]: resized, then normalized
    per tower (DINOv2's channels first, SigLIP's second)."""
    resized = lanczos_resize_uint8(np.ascontiguousarray(image, np.uint8), image_size, image_size)
    x = resized.astype(np.float32) / 255.0
    sig = (x - SIGLIP_MEAN) / SIGLIP_STD
    if fused:
        stacked = np.concatenate([(x - IMAGENET_MEAN) / IMAGENET_STD, sig], axis=-1)
    else:
        stacked = sig
    return stacked.transpose(2, 0, 1)[None]


class StubLlamaTokenizer:
    """A LLaMA-shaped stand-in (BOS 1, words hashed into the vocabulary) for
    models without a tokenizer. Python's string hash is salted per process,
    so its ids hold within one process only."""

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 32000

    def __call__(self, text: str, return_tensors: Optional[str] = None):
        ids = [self.bos_token_id] + [
            abs(hash(w)) % (self.vocab_size - 3000) + 3 for w in text.split()
        ]
        arr = np.array([ids], np.int32)
        return {"input_ids": arr, "attention_mask": np.ones_like(arr)}


class OpenVLAProcessor:
    def __init__(self, tokenizer=None, image_size: int = 224, fused: bool = True):
        self.tokenizer = tokenizer or StubLlamaTokenizer()
        self.image_size = image_size
        self.fused = fused

    def __call__(self, prompt: str, image: np.ndarray) -> dict:
        ids = np.asarray(self.tokenizer(prompt, return_tensors="np")["input_ids"], np.int32)
        return {
            "input_ids": ids,
            "attention_mask": np.ones_like(ids),
            "pixel_values": process_image(np.asarray(image), self.image_size, self.fused),
        }


def load_hf_tokenizer(model_id_or_path: str):
    """The tokenizer of a local snapshot directory through ``transformers``
    (never fetched: ``local_files_only``), or None where it cannot be loaded
    (then the stub serves)."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_id_or_path, trust_remote_code=True,
                                             local_files_only=True)
    except Exception:
        return None
