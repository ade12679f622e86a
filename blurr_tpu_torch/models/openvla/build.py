"""OpenVLA-family model construction from a model id.

Counterpart of ``blurr_tpu/models/openvla/build.py``, the one resolution of
a model id that the action server and its CLI use:

- an HF snapshot directory (OpenVLA / OpenVLA-OFT): the spec from its
  ``blurr_spec.json`` (else OpenVLA-7B's), the weights, the norm and
  dataset statistics and the tokenizer from its files;
- a checkpoint-free id of ``model.RANDOM_SPECS`` ('random', 'random-7b',
  'random-minivla', ...): random weights drawn on the device from a
  generator seeded with ``seed``.

OFT adds the continuous head (and the proprio projector), loaded from the
snapshot where its files are, else drawn. ``quantization`` 'w8a8' / 'w4a8'
quantizes the LLM in place; for a checkpoint-free id,
``memory_safe_quant_init`` builds the LLM quantized directly instead, its
int8 bytes drawn on the device, so a 7B never exists in bf16 (JAX's does so
from 32 layers on; the port at every depth, so the small ids the tests
build take the path a 7B takes). An orbax
``checkpoint_path`` (the JAX trainer's output) raises
``NotImplementedError``: it comes with the training port (ROADMAP M13).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from blurr_tpu_torch.ops.quant import QUANTIZED_LINEARS, W4A8Linear


@dataclasses.dataclass
class BuiltVLA:
    model: object            # OpenVLA or OpenVLAOFT, holding its weights
    spec: object             # OpenVLASpec
    tokenizer: object        # None for checkpoint-free ids
    norm_stats: Optional[dict]
    dataset_stats: Optional[dict]


def _refuse_checkpoint(checkpoint_path) -> None:
    if checkpoint_path:
        raise NotImplementedError(
            f"checkpoint_path {checkpoint_path!r}: orbax trees from the JAX trainer "
            "are not read yet; they come with the training port (ROADMAP M13)"
        )


def build_openvla(
    model_id: str,
    *,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    oft: bool = False,
    chunk_len: int = 8,
    use_proprio: bool = False,
    proprio_dim: int = 8,
    quantization: Optional[str] = None,
    memory_safe_quant_init: bool = False,
    checkpoint_path: Optional[str] = None,
    seed: int = 0,
) -> BuiltVLA:
    from blurr_tpu_torch.models.openvla.llama import quantize_llama_w4a8, quantize_llama_w8a8
    from blurr_tpu_torch.models.openvla.model import (
        RANDOM_SPECS,
        OpenVLA,
        OpenVLAOFT,
        OpenVLASpec,
        init_dense,
    )

    if quantization in ("none", ""):
        quantization = None
    if quantization not in (None, "w8a8", "w4a8"):
        raise ValueError(f"quantization {quantization!r}: expected None/'w8a8'/'w4a8'")
    generator = torch.Generator(device=device).manual_seed(seed)

    def make_model(spec, norm_stats=None, quant_init=None):
        kw = dict(device=device, dtype=dtype, quant_init=quant_init)
        if oft:
            return OpenVLAOFT(spec, norm_stats, chunk_len, use_proprio, proprio_dim, **kw)
        return OpenVLA(spec, norm_stats, **kw)

    norm_stats = dataset_stats = tokenizer = None
    path = Path(str(model_id)).expanduser()
    if path.is_dir():
        from blurr_tpu_torch.models.openvla.checkpoint import (
            load_dataset_statistics,
            load_norm_stats,
            load_oft_aux_params,
            load_openvla_hf_dir,
        )
        from blurr_tpu_torch.models.openvla.processing import load_hf_tokenizer

        _refuse_checkpoint(checkpoint_path)
        spec = OpenVLASpec.from_snapshot_dir(path)
        norm_stats = load_norm_stats(str(path))
        dataset_stats = load_dataset_statistics(str(path))
        tokenizer = load_hf_tokenizer(str(path))
        model = load_openvla_hf_dir(make_model(spec, norm_stats), str(path))
        if oft:
            head, proj = load_oft_aux_params(str(path), device, dtype)
            if head is None:
                init_dense(model.action_head, generator)
            else:
                model.action_head = head
            if use_proprio:
                if proj is None:
                    init_dense(model.proprio_projector, generator)
                else:
                    model.proprio_projector = proj
    else:
        if str(model_id) not in RANDOM_SPECS:
            raise ValueError(f"model_id {model_id!r}: pass an HF snapshot dir or one "
                             f"of {sorted(RANDOM_SPECS)}")
        _refuse_checkpoint(checkpoint_path)
        spec = RANDOM_SPECS[str(model_id)]()
        if quantization and memory_safe_quant_init:
            model = make_model(spec, quant_init=quantization).init_params(generator)
            return BuiltVLA(model.eval(), spec, None, None, None)
        model = make_model(spec).init_params(generator)

    if quantization is not None:
        if _llama_has_quant_dicts(model.llama):
            raise ValueError("params already quantized")
        if _llama_has_lora_dicts(model.llama):
            raise ValueError("the LLM carries LoRA factors; PTQ would skip the wrapped "
                             "projections. Merge the adapter first.")
        (quantize_llama_w8a8 if quantization == "w8a8" else quantize_llama_w4a8)(model.llama)
    return BuiltVLA(model.eval(), spec, tokenizer, norm_stats, dataset_stats)


def _has(llama, keys: set, classes: tuple) -> bool:
    """Whether the LLM (a module, or a JAX-layout tree) holds a module of
    ``classes`` or a weight dict with one of ``keys``."""
    if isinstance(llama, nn.Module):
        return any(isinstance(m, classes) for m in llama.modules())
    return isinstance(llama, dict) and (
        bool(keys & set(llama)) or any(_has(v, keys, classes) for v in llama.values()))


def _llama_has_quant_dicts(llama) -> bool:
    """A quantized weight anywhere: such an LLM must not be quantized again."""
    return _has(llama, {"q", "q8a", "q4", "fp"}, QUANTIZED_LINEARS)


def llama_has_w4a8(llama) -> bool:
    """A w4a8 weight anywhere (block-major packed per chip, so tensor
    parallelism must refuse it)."""
    return _has(llama, {"q4"}, (W4A8Linear,))


def _llama_has_lora_dicts(llama) -> bool:
    """A LoRA factor dict anywhere (a JAX tree; the port's modules hold none)."""
    return _has(llama, {"lora_a"}, ())
