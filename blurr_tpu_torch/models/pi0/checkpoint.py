"""Load a JAX Pi-0 parameter tree into the port's ``PiZero``.

Counterpart of the parameter layouts of ``blurr_tpu/models/pi0``
(``PiZero.init_params`` in ``pizero.py``, ``init_siglip_params`` in
``siglip.py``, ``init_mixture_params`` in ``joint.py``). The tree holds
numpy arrays (JAX [in, out] matrices, layers stacked on a leading [L, ...]
axis). ``load_jax_params`` unstacks the layers into the per-layer modules
and transposes the matrices into ``nn.Linear``'s [out, in]. The port always
ties the proprio mixture to the action mixture, so a tree whose proprio
arrays differ from its action arrays is refused.

A quantized tree (``enable_action_quantization`` / ``enable_vlm_quantization``
in JAX) has dict leaves, stacked per layer in the mixtures: w4a8 ``{"q4"
[L, NB, K//2, BN], "s" [L, G, N]}``, w8a8 ``{"q8a" [L, K, N], "s" [L, N]}``,
int8 weight-only ``{"q" [L, K, N], "s" [L, N]}`` and cached-fp ``{"fp"
[L, K, N]}`` (the int8 kinds also on the action encoder, unstacked, beside
their fp biases). They load into a model quantized the same way (its
``enable_*_quantization`` run first): the int8 bytes are copied as they
are, the scales stay fp32 and the cached-fp copy keeps its bf16. A dict
whose kind differs from the model's module there is refused.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops.quant import CachedFpLinear, Int8Linear, W4A8Linear, W8A8Linear

_MIXTURE_MATRICES = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
    "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj",
}
_SIGLIP_LAYER = {
    "q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj",
    "fc1": "fc1", "fc2": "fc2",
}


# the tensors of each kind of weight, by the module that holds them
_KINDS = ((W4A8Linear, ("q4", "s")), (W8A8Linear, ("q8a", "s")),
          (Int8Linear, ("q", "s")), (CachedFpLinear, ("fp",)))


def _weight(mod, leaf, i=None):
    """(tensor, array) pairs of one linear's weight: a plain JAX [in, out]
    matrix into an ``nn.Linear``, a quantized dict into the module of its
    kind. ``i`` picks one layer of a stacked leaf."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if not isinstance(leaf, dict):
        if type(mod) is not nn.Linear:
            raise ValueError(
                f"the tree holds a plain weight where the model has a "
                f"{type(mod).__name__}: quantize the tree as the model is"
            )
        yield mod.weight, pick(leaf).T
        return
    for cls, keys in _KINDS:
        if set(leaf) == set(keys):
            if not isinstance(mod, cls):
                raise ValueError(
                    f"the tree holds a {cls.__name__} weight {sorted(leaf)} "
                    f"where the model has a {type(mod).__name__}"
                )
            for key in keys:
                yield getattr(mod, key), pick(leaf[key])
            return
    raise NotImplementedError(
        f"weight dict with keys {sorted(leaf)}: only the w4a8 {{q4, s}}, w8a8 "
        "{q8a, s}, int8 {q, s} and cached-fp {fp} kinds are ported"
    )


def _linear(mod, tree: Dict, w: str, b: str, i=None):
    yield from _weight(mod, tree[w], i)
    yield mod.bias, tree[b] if i is None else tree[b][i]


def _pairs(model: PiZero, tree: Dict) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """(port parameter, JAX array) for every parameter of the model."""
    yield model.embed_tokens, tree["embed_tokens"]

    sg = tree["siglip"]
    vt = model.vision_tower
    yield from _linear(vt.patch_embedding, sg, "patch_w", "patch_b")
    yield vt.position_embedding, sg["pos_embed"]
    lp = sg["layers"]
    for i, layer in enumerate(vt.layers):
        for ln, key in ((layer.layer_norm1, "ln1"), (layer.layer_norm2, "ln2")):
            yield ln.weight, lp[f"{key}_w"][i]
            yield ln.bias, lp[f"{key}_b"][i]
        for key, attr in _SIGLIP_LAYER.items():
            yield from _linear(getattr(layer, attr), lp, f"{key}_w", f"{key}_b", i)
    yield vt.post_layernorm.weight, sg["post_ln_w"]
    yield vt.post_layernorm.bias, sg["post_ln_b"]

    yield from _linear(model.multi_modal_projector, tree["projector"], "w", "b")

    for name in ("vlm", "action"):
        mp = tree["joint"][name]
        mixture = model.joint[name]
        for i, layer in enumerate(mixture.layers):
            for key, attr in _MIXTURE_MATRICES.items():
                yield from _weight(getattr(layer, attr), mp[key], i)
            yield layer.input_norm, mp["input_norm"]["scale"][i]
            yield layer.post_norm, mp["post_norm"]["scale"][i]
        if mixture.final_norm is not None:
            yield mixture.final_norm, mp["final_norm"]["scale"]

    ae = tree["action_encoder"]
    yield from _linear(model.action_encoder_w1, ae, "w1", "b1")
    yield from _linear(model.action_encoder_w2, ae, "w2", "b2")
    yield from _linear(model.action_encoder_w3, ae, "w3", "b3")
    yield from _linear(model.proprio_encoder, tree["proprio_encoder"], "w", "b")
    yield from _linear(model.action_decoder, tree["action_decoder"], "w", "b")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def check_tied(tree: Dict) -> None:
    """Raise unless the tree's proprio mixture equals its action mixture."""
    joint = tree["joint"]
    action = dict(_leaves(joint["action"]))
    proprio = dict(_leaves(joint["proprio"]))
    if action.keys() != proprio.keys() or any(
        action[k].shape != proprio[k].shape
        or not np.array_equal(action[k], proprio[k])
        for k in action
    ):
        raise ValueError(
            "the tree's proprio mixture is not tied to its action mixture; "
            "the port always ties them (tie_action_proprio_weights first)"
        )


@torch.no_grad()
def load_jax_params(model: PiZero, tree: Dict) -> PiZero:
    """Copy the numpy JAX tree into ``model`` in place (each float array cast
    to the tensor's device and dtype, int8 bytes copied as they are). Raises
    on an untied tree, on a shape mismatch, on a quantized dict of another
    kind than the model's module, and when a parameter or buffer of the
    model is left unset."""
    check_tied(tree)
    seen = set()
    for param, arr in _pairs(model, tree):
        arr = np.asarray(arr)
        if arr.dtype != np.int8 and (arr.dtype.kind != "f" or arr.dtype.itemsize < 4):
            arr = arr.astype(np.float32)  # e.g. ml_dtypes bfloat16 (exact)
        if (arr.dtype == np.int8) != (param.dtype == torch.int8):
            raise ValueError(
                f"dtype mismatch: JAX {arr.dtype} for a port tensor of {param.dtype}"
            )
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"shape mismatch: JAX {arr.shape} for a port parameter of "
                f"shape {tuple(param.shape)}"
            )
        param.copy_(torch.from_numpy(np.array(arr)))  # a writable copy
        seen.add(id(param))
    missing = [
        n for n, p in [*model.named_parameters(), *model.named_buffers()]
        if id(p) not in seen
    ]
    if missing:
        raise ValueError(f"parameters not set by the tree: {missing}")
    return model
