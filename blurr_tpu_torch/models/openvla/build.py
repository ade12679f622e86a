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
build take the path a 7B takes).

``checkpoint_path`` is a parameter tree of the port's trainer
(``scripts/train_openvla_lora_torch.py --save-params``: ``params.safetensors``
+ ``tree.json``, read by ``models/pi0/checkpoint.restore_params``). It
replaces every weight: ``model_id`` gives the spec, the tokenizer and the
statistics only, and the model is built in the tree's structure (its LLM
drawn quantized as the tree's bases are, the ``lora/<base kind>``
adapters rebuilt) without a bf16 7B in between. A tree that carries a
quantized LLM refuses ``quantization``, and one that carries LoRA refuses
post-training quantization, as JAX's do. An orbax directory of the JAX
trainer is refused (``restore_params`` names the format it reads).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from blurr_tpu_torch.ops.lora import LoRALinear
from blurr_tpu_torch.ops.quant import QUANTIZED_LINEARS, W4A8Linear


@dataclasses.dataclass
class BuiltVLA:
    model: object            # OpenVLA or OpenVLAOFT, holding its weights
    spec: object             # OpenVLASpec
    tokenizer: object        # None for checkpoint-free ids
    norm_stats: Optional[dict]
    dataset_stats: Optional[dict]


def _tree_quant_init(checkpoint_path: str) -> Optional[str]:
    """The quantized kind of a parameter tree's LLM linears ('w8a8' or
    'w4a8', under an adapter or not) where they share one, else None (an fp
    LLM is built). A directory without the port's ``tree.json`` gives None
    and is refused by ``restore_params``."""
    import json

    tree = Path(checkpoint_path) / "tree.json"
    if not tree.is_file():
        return None
    kinds = {k.removeprefix("lora/") for name, k in json.loads(tree.read_text())
             .get("modules", {}).items() if name.startswith("llama.")}
    return next(iter(kinds)) if len(kinds) == 1 and kinds <= {"w8a8", "w4a8"} else None


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

        spec = OpenVLASpec.from_snapshot_dir(path)
        norm_stats = load_norm_stats(str(path))
        dataset_stats = load_dataset_statistics(str(path))
        tokenizer = load_hf_tokenizer(str(path))
    elif str(model_id) in RANDOM_SPECS:
        spec = RANDOM_SPECS[str(model_id)]()
    else:
        raise ValueError(f"model_id {model_id!r}: pass an HF snapshot dir or one "
                         f"of {sorted(RANDOM_SPECS)}")

    if checkpoint_path:
        from blurr_tpu_torch.models.pi0.checkpoint import restore_params

        # every weight comes from the tree: built uninitialized in its
        # structure, then restored
        model = restore_params(make_model(spec, norm_stats,
                                          _tree_quant_init(str(checkpoint_path))),
                               str(checkpoint_path))
    elif path.is_dir():
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
    elif quantization and memory_safe_quant_init:
        model = make_model(spec, quant_init=quantization).init_params(generator)
        return BuiltVLA(model.eval(), spec, None, None, None)
    else:
        model = make_model(spec).init_params(generator)

    if quantization is not None:
        if _llama_has_quant_dicts(model.llama):
            if checkpoint_path:
                raise ValueError(f"checkpoint {checkpoint_path!r} already carries a quantized "
                                 f"LLM; drop quantization={quantization!r} (the tree serves "
                                 "as-is)")
            raise ValueError("params already quantized")
        if _llama_has_lora_dicts(model.llama):
            raise ValueError("the LLM carries LoRA factor dicts; PTQ would skip the wrapped "
                             "projections. Merge the adapter first (ops.lora.merge_lora_tree) "
                             "or train with --quantize-base.")
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
    """A LoRA adapter anywhere (a ``LoRALinear``, or a JAX tree's factor
    dict): PTQ would skip the wrapped projections."""
    return _has(llama, {"lora_a"}, (LoRALinear,))
