"""OpenVLA weights in: HF snapshots, OFT aux checkpoints and JAX trees.

Counterpart of ``blurr_tpu/models/openvla/checkpoint.py``. The HF
(prismatic) snapshot's keys, read with the port's own safetensors reader
(``models/pi0/checkpoint.load_safetensors_dir``):

    language_model.model.layers.{i}.*    LLaMA-2 (Qwen2: q/k/v biases, no lm_head)
    vision_backbone.featurizer.*         timm DINOv2 ViT-L/14 reg4
    vision_backbone.fused_featurizer.*   timm SigLIP ViT-So400m/14
    projector.fc{1,2,3}.*

``load_openvla_hf_dir`` (what ``build_openvla`` reads a snapshot with)
walks the one key map that ``openvla_hf_state_dict`` writes with, copying
each tensor of the file into its parameter. ``llama_params_from_hf``,
``timm_vit_params_from_hf``, ``prismatic_vision_params`` and
``openvla_params_from_hf_dir`` give JAX's tree instead (matrices [in, out],
layers stacked on a leading axis), its leaves CPU tensors in the file's
dtype, for parity with JAX's bridge; ``load_jax_params`` copies such a
tree, or JAX's own as numpy, into the port's modules, each tensor cast to
its parameter's device and dtype. Quantized JAX leaves (w8a8 ``{"q8a", "s"}``,
w4a8 ``{"q4", "s"}``) load into a model quantized the same way, their
bytes as they are, and JAX's LoRA dicts (``{"w", "lora_a", "lora_b",
"lora_s"}``, over an fp or quantized ``w``) into a model given adapters
the same way (``ops.lora.inject_lora_tree``). A position table of the other
layout than the model's replaces it (``vit.ViT`` takes both). A
``lora_adapter/`` directory in a snapshot (PEFT) is merged into the LLM's
weights as they load (``ops.lora.maybe_merge_lora_adapter``: skipped where
the base already holds it, and left unmerged with a warning where it
cannot be read), unless ``lora`` / ``merge_lora`` is False.

OFT's aux heads ship as ``action_head--{step}_checkpoint.pt`` (keys
prefixed ``module.model.``) and ``proprio_projector--{step}_checkpoint.pt``
(``module.``); the newest step is read, and the modules are rebuilt from
the tensors' shapes.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from blurr_tpu_torch.models.openvla.model import (
    OFTActionHead,
    OFTProprioProjector,
    OpenVLA,
)
from blurr_tpu_torch.models.openvla.vit import ViT
from blurr_tpu_torch.models.pi0.checkpoint import _weight, copy_pairs, load_safetensors_dir
from blurr_tpu_torch.ops.lora import maybe_merge_lora_adapter

log = logging.getLogger(__name__)

_LLAMA_LINEARS = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
    "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj",
}
_HF_LLAMA_LINEARS = {
    "q_w": "self_attn.q_proj", "k_w": "self_attn.k_proj", "v_w": "self_attn.v_proj",
    "o_w": "self_attn.o_proj", "gate_w": "mlp.gate_proj", "up_w": "mlp.up_proj",
    "down_w": "mlp.down_proj",
}
_VIT_LINEARS = {"qkv": "qkv", "out": "proj", "fc1": "fc1", "fc2": "fc2"}
_HF_VIT_LINEARS = {"qkv": "attn.qkv", "out": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def _stack(per: Dict[int, torch.Tensor]) -> torch.Tensor:
    idxs = sorted(per)
    if idxs != list(range(len(idxs))):
        raise ValueError(f"layer indices are not 0 .. n-1: {idxs}")
    return torch.stack([per[i] for i in idxs])


def _per_layer(state: Dict, pattern: str, keep=lambda i: True) -> Dict[str, Dict[int, torch.Tensor]]:
    """{suffix: {layer: tensor}} of the keys matching ``pattern``
    (groups: layer index, suffix)."""
    rx = re.compile(pattern)
    per: Dict[str, Dict[int, torch.Tensor]] = {}
    for k, v in state.items():
        m = rx.match(k)
        if m and keep(int(m.group(1))):
            per.setdefault(m.group(2), {})[int(m.group(1))] = v
    return per


def llama_params_from_hf(state: Dict, prefix: str = "language_model.") -> Dict:
    """The LLM's tree from an HF state dict. Qwen2's q/k/v biases are taken
    where every layer carries all three (a partial set is ignored with a
    warning); a tied model ships no ``lm_head`` and gets none."""
    per = _per_layer(state, re.escape(prefix) + r"model\.layers\.(\d+)\.(.+)")

    def lin(name):
        return _stack({i: w.t() for i, w in per[name + ".weight"].items()})

    layers = {key: lin(name) for key, name in _HF_LLAMA_LINEARS.items()}
    layers["input_norm"] = _stack(per["input_layernorm.weight"])
    layers["post_norm"] = _stack(per["post_attention_layernorm.weight"])
    bias_names = [f"self_attn.{p}_proj.bias" for p in ("q", "k", "v")]
    n_layers = len(per["input_layernorm.weight"])
    if any(n in per for n in bias_names):
        if all(len(per.get(n, {})) == n_layers for n in bias_names):
            for p, n in zip("qkv", bias_names):
                layers[f"{p}_b"] = _stack(per[n])
        else:
            log.warning("Partial attention-bias set in checkpoint (expected q/k/v "
                        "biases on all %d layers); ignoring biases.", n_layers)
    params = {
        "embed_tokens": state[prefix + "model.embed_tokens.weight"],
        "layers": layers,
        "final_norm": state[prefix + "model.norm.weight"],
    }
    if prefix + "lm_head.weight" in state:
        params["lm_head"] = state[prefix + "lm_head.weight"].t()
    return params


def timm_vit_params_from_hf(state: Dict, prefix: str, num_blocks: int) -> Dict:
    """A timm ViT's tree (blocks.{i}.{norm1, attn.qkv, attn.proj, ls1,
    norm2, mlp.fc1, mlp.fc2, ls2}, patch_embed.proj, pos_embed, cls_token,
    reg_token), the first ``num_blocks`` blocks only (the ones that run)."""
    per = _per_layer(state, re.escape(prefix) + r"blocks\.(\d+)\.(.+)", lambda i: i < num_blocks)
    conv_w = state[prefix + "patch_embed.proj.weight"]  # [D, C, p, p]
    layers = {}
    for key, name in _HF_VIT_LINEARS.items():
        layers[f"{key}_w"] = _stack({i: w.t() for i, w in per[name + ".weight"].items()})
        layers[f"{key}_b"] = _stack(per[name + ".bias"])
    for key, name in (("ln1", "norm1"), ("ln2", "norm2")):
        layers[f"{key}_w"] = _stack(per[name + ".weight"])
        layers[f"{key}_b"] = _stack(per[name + ".bias"])
    if "ls1.gamma" in per:
        layers["ls1"] = _stack(per["ls1.gamma"])
        layers["ls2"] = _stack(per["ls2.gamma"])
    params = {
        "patch_w": conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0]),
        "patch_b": state[prefix + "patch_embed.proj.bias"],
        "pos_embed": state[prefix + "pos_embed"][0],
        "layers": layers,
    }
    if prefix + "cls_token" in state:
        params["cls_token"] = state[prefix + "cls_token"]
    if prefix + "reg_token" in state:
        params["reg_tokens"] = state[prefix + "reg_token"]
    return params


def prismatic_vision_params(state: Dict, spec) -> Tuple[Dict, Dict]:
    """The single-tower prismatic (MiniVLA) vision tree and its 2-linear
    projector from a ``.pt`` state dict (``projector.projector.{0,2}`` or
    ``projector.fc{1,2}``). Raises KeyError where the layout differs."""
    vit = timm_vit_params_from_hf(state, "vision_backbone.featurizer.",
                                  spec.siglip.effective_num_layers)

    def pick(*names):
        for n in names:
            if n in state:
                return state[n]
        raise KeyError(f"projector tensor not found; tried {names}")

    proj = {
        "fc1_w": pick("projector.projector.0.weight", "projector.fc1.weight").t(),
        "fc1_b": pick("projector.projector.0.bias", "projector.fc1.bias"),
        "fc2_w": pick("projector.projector.2.weight", "projector.fc2.weight").t(),
        "fc2_b": pick("projector.projector.2.bias", "projector.fc2.bias"),
    }
    return vit, proj


def openvla_params_from_hf_dir(path: str, spec, merge_lora: bool = True) -> Dict:
    """A fused OpenVLA snapshot directory -> the model's tree (``llama``,
    ``dinov2``, ``siglip``, ``projector``), its ``lora_adapter/`` merged into
    the LLM unless ``merge_lora`` is False."""
    state = load_safetensors_dir(path)
    projector = {}
    for name in ("fc1", "fc2", "fc3"):
        projector[f"{name}_w"] = state[f"projector.{name}.weight"].t()
        projector[f"{name}_b"] = state[f"projector.{name}.bias"]
    llama = llama_params_from_hf(state)
    if merge_lora:
        maybe_merge_lora_adapter(llama, path)
    return {
        "llama": llama,
        "dinov2": timm_vit_params_from_hf(state, "vision_backbone.featurizer.",
                                          spec.dinov2.effective_num_layers),
        "siglip": timm_vit_params_from_hf(state, "vision_backbone.fused_featurizer.",
                                          spec.siglip.effective_num_layers),
        "projector": projector,
    }


# ---------------------------------------------------------------------------
# Trees into modules
# ---------------------------------------------------------------------------


def llama_pairs(llama, lt: Dict):
    """(port tensor, tree leaf) of the LLM: each layer's linears (plain or
    quantized), norms and Qwen2 biases, the embedding, the final norm and
    the head."""
    yield llama.embed_tokens, lt["embed_tokens"]
    lp = lt["layers"]
    for i, layer in enumerate(llama.layers):
        for key, attr in _LLAMA_LINEARS.items():
            yield from _weight(getattr(layer, attr), lp[key], i)
        yield layer.input_norm, lp["input_norm"][i]
        yield layer.post_norm, lp["post_norm"][i]
        for key in ("q_b", "k_b", "v_b"):
            if hasattr(layer, key):
                yield getattr(layer, key), lp[key][i]
    yield llama.final_norm, lt["final_norm"]
    if "lm_head" in lt:
        if llama.lm_head is None:
            raise ValueError("the tree holds an lm_head; the model's head is tied "
                             "(quantize the model as the tree is)")
        yield from _weight(llama.lm_head, lt["lm_head"])


def vit_pairs(vit: ViT, vt: Dict):
    """(port tensor, tree leaf) of a ViT tower. A position table whose row
    count differs from the model's (the other layout) replaces it."""
    pos = vt["pos_embed"]
    if tuple(pos.shape) != tuple(vit.pos_embed.shape):
        old = vit.pos_embed
        vit.pos_embed = nn.Parameter(torch.empty(tuple(pos.shape), dtype=old.dtype,
                                                 device=old.device))
    yield vit.patch_embed.weight, vt["patch_w"].T
    yield vit.patch_embed.bias, vt["patch_b"]
    yield vit.pos_embed, pos
    for name in ("cls_token", "reg_tokens"):
        if hasattr(vit, name):
            yield getattr(vit, name), vt[name]
    lp = vt["layers"]
    for i, block in enumerate(vit.blocks):
        for key, attr in _VIT_LINEARS.items():
            yield getattr(block, attr).weight, lp[f"{key}_w"][i].T
            yield getattr(block, attr).bias, lp[f"{key}_b"][i]
        for key, attr in (("ln1", "norm1"), ("ln2", "norm2")):
            yield getattr(block, attr).weight, lp[f"{key}_w"][i]
            yield getattr(block, attr).bias, lp[f"{key}_b"][i]
        if block.spec.layerscale:
            yield block.ls1, lp["ls1"][i]
            yield block.ls2, lp["ls2"][i]


def _dense_pairs(mod: nn.Linear, t: Dict, key: str):
    yield mod.weight, t[f"{key}_w"].T
    yield mod.bias, t[f"{key}_b"]


def projector_pairs(projector, pt: Dict):
    for name in ("fc1", "fc2", "fc3"):
        if getattr(projector, name) is not None:
            yield from _dense_pairs(getattr(projector, name), pt, name)


def action_head_pairs(head: OFTActionHead, ht: Dict):
    """JAX's OFT head tree (``ln1``, ``fc1``, stacked ``blocks``, ``ln2``,
    ``fc2``) onto the module."""
    yield head.layer_norm1.weight, ht["ln1_w"]
    yield head.layer_norm1.bias, ht["ln1_b"]
    yield from _dense_pairs(head.fc1, ht, "fc1")
    bt = ht["blocks"]
    for i, block in enumerate(head.mlp_resnet_blocks):
        ln, lin = block["ffn"]
        yield ln.weight, bt["ln_w"][i]
        yield ln.bias, bt["ln_b"][i]
        yield lin.weight, bt["w"][i].T
        yield lin.bias, bt["b"][i]
    yield head.layer_norm2.weight, ht["ln2_w"]
    yield head.layer_norm2.bias, ht["ln2_b"]
    yield from _dense_pairs(head.fc2, ht, "fc2")


def _pairs(model: OpenVLA, tree: Dict):
    yield from llama_pairs(model.llama, tree["llama"])
    yield from vit_pairs(model.siglip, tree["siglip"])
    if model.dinov2 is not None:
        yield from vit_pairs(model.dinov2, tree["dinov2"])
    yield from projector_pairs(model.projector, tree["projector"])
    if hasattr(model, "action_head"):
        yield from action_head_pairs(model.action_head, tree["action_head"])
        if model.proprio_projector is not None:
            pt = tree["proprio_projector"]
            yield from _dense_pairs(model.proprio_projector.fc1, pt, "fc1")
            yield from _dense_pairs(model.proprio_projector.fc2, pt, "fc2")


def load_jax_params(model: OpenVLA, tree: Dict) -> OpenVLA:
    """Copy a JAX-layout tree (JAX's as numpy, or this module's from a
    snapshot) into ``model`` in place, every tensor cast to its parameter's
    device and dtype, quantized bytes as they are. Raises on a shape or kind
    mismatch (quantize the model and inject its adapters as the tree is
    first) and when a parameter or buffer of the model is left unset."""
    copy_pairs(model, _pairs(model, tree))
    return model


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------


def load_norm_stats(path: str) -> Optional[Dict]:
    """A snapshot's ``dataset_statistics.json``, else its ``config.json``'s
    ``norm_stats``, else None."""
    p = os.path.join(path, "dataset_statistics.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    p = os.path.join(path, "config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f).get("norm_stats")
    return None


def load_dataset_statistics(path: str) -> Optional[Dict]:
    """``dataset_statistics.json`` only (no ``config.json`` fallback)."""
    p = os.path.join(path, "dataset_statistics.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def infer_unnorm_key(norm_stats: Dict, requested: Optional[str] = None,
                     dataset_stats: Optional[Dict] = None,
                     prefer_dataset_stats: bool = False) -> Optional[str]:
    """An explicit key (KeyError where absent), else the first of the
    fallbacks in the order of the script mirrored: the eval's (default)
    'bridge_orig' > the first dataset-statistics key also in
    ``norm_stats``; the benchmark's (``prefer_dataset_stats``) the other
    way round; then the first ``norm_stats`` key; else None."""
    if requested:
        if requested in norm_stats:
            return requested
        raise KeyError(f"unnorm_key {requested!r} not in norm_stats")
    inter = [k for k in (dataset_stats or {}) if k in norm_stats]
    bridge = ["bridge_orig"] if "bridge_orig" in norm_stats else []
    for cands in ((inter[:1], bridge) if prefer_dataset_stats else (bridge, inter[:1])):
        if cands:
            return cands[0]
    if norm_stats:
        return next(iter(norm_stats))
    return None


# ---------------------------------------------------------------------------
# OFT aux checkpoints
# ---------------------------------------------------------------------------


def _latest_by_step(paths):
    """The newest checkpoint by its NUMERIC step (--10 after --9)."""
    def step_of(p):
        m = re.search(r"--(\d+)_checkpoint\.pt$", p)
        return int(m.group(1)) if m else -1

    return max(paths, key=step_of)


def _strip(state: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {k.removeprefix(prefix): v for k, v in state.items() if k.startswith(prefix)}


def load_oft_aux_params(path: str, device, dtype=torch.bfloat16
                        ) -> Tuple[Optional[OFTActionHead], Optional[OFTProprioProjector]]:
    """The newest ``action_head--*.pt`` / ``proprio_projector--*.pt`` of
    ``path`` as modules on ``device`` in ``dtype``, their sizes and block
    count read from the tensors (None where there is no file)."""
    head = proj = None
    heads = glob.glob(os.path.join(path, "action_head--*_checkpoint.pt"))
    if heads:
        state = _strip(torch.load(_latest_by_step(heads), map_location="cpu"), "module.model.")
        n_blocks = len({k.split(".")[1] for k in state if k.startswith("mlp_resnet_blocks.")})
        hidden, in_dim = state["fc1.weight"].shape
        head = OFTActionHead(in_dim, hidden, state["fc2.weight"].shape[0], n_blocks,
                             device="meta", dtype=dtype)
        head.load_state_dict(state, assign=True)
        head.to(device, dtype)
    projs = glob.glob(os.path.join(path, "proprio_projector--*_checkpoint.pt"))
    if projs:
        # proprio checkpoints prefix with "module." only
        state = _strip(torch.load(_latest_by_step(projs), map_location="cpu"), "module.")
        hidden, in_dim = state["fc1.weight"].shape
        proj = OFTProprioProjector(in_dim, hidden, state["fc2.weight"].shape[0],
                                   device="meta", dtype=dtype)
        proj.load_state_dict(state, assign=True)
        proj.to(device, dtype)
    return head, proj


def save_oft_aux_params(path: str, action_head: Optional[OFTActionHead] = None,
                        proprio_projector: Optional[OFTProprioProjector] = None,
                        step: int = 0) -> None:
    """``load_oft_aux_params``'s inverse: the modules as the reference's
    torch checkpoints (fp32 CPU tensors, ``module.model.`` / ``module.``
    prefixes)."""
    os.makedirs(path, exist_ok=True)
    for mod, prefix, name in ((action_head, "module.model.", "action_head"),
                              (proprio_projector, "module.", "proprio_projector")):
        if mod is not None:
            state = {prefix + k: v.detach().float().cpu().contiguous()
                     for k, v in mod.state_dict().items()}
            torch.save(state, os.path.join(path, f"{name}--{step}_checkpoint.pt"))



def load_openvla_hf_dir(model: OpenVLA, path: str, lora: bool = True) -> OpenVLA:
    """A fused snapshot directory's weights into the model's LLM, towers and
    projector in place (an OFT model's head is left to
    ``load_oft_aux_params``), through the key map the writer uses
    (``openvla_hf_state_dict``): each tensor of the file copied into its
    parameter, cast to the parameter's device and dtype, with no stacked or
    transposed copy on the host. A position table of the other layout than
    a tower's replaces it; the blocks a tower never runs are not read.
    Raises on a missing key or a shape mismatch. A ``lora_adapter/``
    directory is then merged into the LLM (``maybe_merge_lora_adapter``)
    unless ``lora`` is False, which ignores it (JAX's ``merge_lora=False``)."""
    state = load_safetensors_dir(path)
    for vit, prefix in ((model.dinov2, "vision_backbone.featurizer."),
                        (model.siglip, "vision_backbone.fused_featurizer.")):
        pos = state[prefix + "pos_embed"]
        if pos.shape[1] != vit.pos_embed.shape[0]:
            old = vit.pos_embed
            vit.pos_embed = nn.Parameter(torch.empty(tuple(pos.shape[1:]), dtype=old.dtype,
                                                     device=old.device))
    head = "language_model.lm_head.weight"
    if head in state and model.llama.lm_head is None:
        raise ValueError(f"the snapshot holds {head}; the model's head is tied")
    with torch.no_grad():
        for key, dst in openvla_hf_state_dict(model).items():
            if key not in state:
                raise KeyError(f"{key} is not in the snapshot {path}")
            src = state[key]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} in the snapshot, "
                                 f"{tuple(dst.shape)} in the model")
            dst.copy_(src)
    if lora:
        maybe_merge_lora_adapter(model.llama, path)
    return model


# ---------------------------------------------------------------------------
# Snapshots out
# ---------------------------------------------------------------------------


def _fp_weight(key: str, mod) -> torch.Tensor:
    if type(mod) is not nn.Linear:
        raise ValueError(f"{key} is a {type(mod).__name__}: an HF snapshot holds fp "
                         "weights, so write it before quantizing")
    return mod.weight


def _vit_keys(vit: ViT, prefix: str):
    d, p = vit.spec.hidden_size, vit.spec.patch_size
    yield prefix + "patch_embed.proj.weight", (
        vit.patch_embed.weight.reshape(d, p, p, vit.spec.num_channels).permute(0, 3, 1, 2))
    yield prefix + "patch_embed.proj.bias", vit.patch_embed.bias
    yield prefix + "pos_embed", vit.pos_embed[None]
    for name, key in (("cls_token", "cls_token"), ("reg_tokens", "reg_token")):
        if hasattr(vit, name):
            yield prefix + key, getattr(vit, name)
    for i, block in enumerate(vit.blocks):
        bp = f"{prefix}blocks.{i}."
        for key, name in _HF_VIT_LINEARS.items():
            lin = getattr(block, _VIT_LINEARS[key])
            yield bp + name + ".weight", lin.weight
            yield bp + name + ".bias", lin.bias
        for attr in ("norm1", "norm2"):
            yield bp + attr + ".weight", getattr(block, attr).weight
            yield bp + attr + ".bias", getattr(block, attr).bias
        if block.spec.layerscale:
            yield bp + "ls1.gamma", block.ls1
            yield bp + "ls2.gamma", block.ls2


def _llama_keys(llama, p: str) -> Dict[str, torch.Tensor]:
    """The HF keys of the LLM under the prefix ``p``."""
    out = {p + "model.embed_tokens.weight": llama.embed_tokens,
           p + "model.norm.weight": llama.final_norm}
    if llama.lm_head is not None:
        out[p + "lm_head.weight"] = _fp_weight("lm_head", llama.lm_head)
    for i, layer in enumerate(llama.layers):
        lp = f"{p}model.layers.{i}."
        for key, name in _HF_LLAMA_LINEARS.items():
            out[lp + name + ".weight"] = _fp_weight(name, getattr(layer, _LLAMA_LINEARS[key]))
        out[lp + "input_layernorm.weight"] = layer.input_norm
        out[lp + "post_attention_layernorm.weight"] = layer.post_norm
        for q in ("q", "k", "v"):
            if hasattr(layer, f"{q}_b"):
                out[f"{lp}self_attn.{q}_proj.bias"] = getattr(layer, f"{q}_b")
    return out


def openvla_hf_state_dict(model: OpenVLA) -> Dict[str, torch.Tensor]:
    """The HF key map of a fused model with fp weights, used both ways:
    {HF key: the model's own tensor or a view of it (the patch linear as
    the HF convolution, the position table with its batch axis)}.
    ``save_openvla_snapshot`` writes it and ``load_openvla_hf_dir`` copies
    the file's tensors into it; the blocks that never run are absent."""
    out = _llama_keys(model.llama, "language_model.")
    out.update(_vit_keys(model.dinov2, "vision_backbone.featurizer."))
    out.update(_vit_keys(model.siglip, "vision_backbone.fused_featurizer."))
    for name in ("fc1", "fc2", "fc3"):
        out[f"projector.{name}.weight"] = getattr(model.projector, name).weight
        out[f"projector.{name}.bias"] = getattr(model.projector, name).bias
    return out


@torch.no_grad()
def save_openvla_snapshot(model: OpenVLA, path: str,
                          dataset_stats: Optional[Dict] = None) -> None:
    """A snapshot directory ``build_openvla`` loads: ``model.safetensors``
    (``openvla_hf_state_dict``, in the model's dtype), ``blurr_spec.json``
    (the spec) and, where given, ``dataset_statistics.json``."""
    import dataclasses

    from blurr_tpu_torch.models.pi0.checkpoint import save_safetensors

    os.makedirs(path, exist_ok=True)
    save_safetensors({k: v.detach().contiguous() for k, v in openvla_hf_state_dict(model).items()},
                     os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "blurr_spec.json"), "w") as f:
        json.dump(dataclasses.asdict(model.spec), f)
    if dataset_stats is not None:
        with open(os.path.join(path, "dataset_statistics.json"), "w") as f:
            json.dump(dataset_stats, f)
