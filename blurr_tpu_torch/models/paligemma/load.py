"""Weights into the standalone PaliGemma and Gemma models.

``load_hf_model`` is the counterpart of ``blurr_tpu/models/paligemma/load.py``
(the reference's ``src/model/paligemma/load.py``): ``config.json`` and the
``*.safetensors`` shards of a local directory onto the card. The key map is
the Pi-0 checkpoint module's (``checkpoint.load_paligemma_safetensors``),
which reads the files with the port's own safetensors reader.
``load_jax_params`` copies the numpy tree of JAX's
``PaliGemmaForConditionalGeneration`` into either model, through the Pi-0
checkpoint module's SigLIP and mixture maps.
"""

from __future__ import annotations

import json
import os

from typing import Dict, Union

import torch

from blurr_tpu_torch.models.paligemma.config import PaliGemmaConfig
from blurr_tpu_torch.models.paligemma.model import (
    GemmaForCausalLM,
    PaliGemmaForConditionalGeneration,
)
from blurr_tpu_torch.models.pi0.checkpoint import (
    copy_pairs,
    linear_pairs,
    load_paligemma_safetensors,
    mixture_pairs,
    siglip_pairs,
)

TextModel = Union[PaliGemmaForConditionalGeneration, GemmaForCausalLM]


def _pairs(model: TextModel, tree: Dict):
    yield model.embed_tokens, tree["embed_tokens"]
    if isinstance(model, PaliGemmaForConditionalGeneration):
        yield from siglip_pairs(model.vision_tower, tree["siglip"])
        yield from linear_pairs(model.multi_modal_projector, tree["projector"], "w", "b")
    yield from mixture_pairs(model.vlm, tree["joint"]["vlm"])


def load_jax_params(model: TextModel, tree: Dict) -> TextModel:
    """Copy the numpy tree of JAX's PaliGemma into ``model`` in place (each
    array cast to the tensor's device and dtype); Gemma takes the embedding
    and the vlm mixture and has no vision tower. Raises on a shape mismatch
    and when a parameter of the model is left unset."""
    copy_pairs(model, _pairs(model, tree))
    return model


def load_hf_model(model_path: str, dtype: torch.dtype = torch.bfloat16,
                  device="cuda") -> PaliGemmaForConditionalGeneration:
    """The model of a local PaliGemma snapshot directory, its weights cast to
    ``dtype`` on ``device``."""
    with open(os.path.join(model_path, "config.json")) as f:
        config = PaliGemmaConfig(**json.load(f))
    model = PaliGemmaForConditionalGeneration(config, device=device, dtype=dtype)
    load_paligemma_safetensors(model.embed_tokens, model.vision_tower,
                               model.multi_modal_projector, model.vlm, model_path)
    return model
