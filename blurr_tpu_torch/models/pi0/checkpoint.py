"""Load a JAX Pi-0 parameter tree into the port's ``PiZero``.

Counterpart of the parameter layouts of ``blurr_tpu/models/pi0``
(``PiZero.init_params`` in ``pizero.py``, ``init_siglip_params`` in
``siglip.py``, ``init_mixture_params`` in ``joint.py``). The tree holds
numpy arrays (JAX [in, out] matrices, layers stacked on a leading [L, ...]
axis). ``load_jax_params`` unstacks the layers into the per-layer modules
and transposes the matrices into ``nn.Linear``'s [out, in]. The port always
ties the proprio mixture to the action mixture, so a tree whose proprio
arrays differ from its action arrays is refused.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from blurr_tpu_torch.models.pi0.pizero import PiZero

_MIXTURE_MATRICES = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
    "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj",
}
_SIGLIP_LAYER = {
    "q": "q_proj", "k": "k_proj", "v": "v_proj", "out": "out_proj",
    "fc1": "fc1", "fc2": "fc2",
}


def _linear(mod, tree: Dict, w: str, b: str):
    yield mod.weight, tree[w].T
    yield mod.bias, tree[b]


def _pairs(model: PiZero, tree: Dict) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """(port parameter, JAX array) for every parameter of the model."""
    yield model.embed_tokens, tree["embed_tokens"]

    sg = tree["siglip"]
    vt = model.vision_tower
    yield from _linear(vt.patch_embedding, sg, "patch_w", "patch_b")
    yield vt.position_embedding, sg["pos_embed"]
    for i, layer in enumerate(vt.layers):
        lp = {k: v[i] for k, v in sg["layers"].items()}
        for ln, key in ((layer.layer_norm1, "ln1"), (layer.layer_norm2, "ln2")):
            yield ln.weight, lp[f"{key}_w"]
            yield ln.bias, lp[f"{key}_b"]
        for key, attr in _SIGLIP_LAYER.items():
            yield from _linear(getattr(layer, attr), lp, f"{key}_w", f"{key}_b")
    yield vt.post_layernorm.weight, sg["post_ln_w"]
    yield vt.post_layernorm.bias, sg["post_ln_b"]

    yield from _linear(model.multi_modal_projector, tree["projector"], "w", "b")

    for name in ("vlm", "action"):
        mp = tree["joint"][name]
        mixture = model.joint[name]
        for i, layer in enumerate(mixture.layers):
            for key, attr in _MIXTURE_MATRICES.items():
                yield getattr(layer, attr).weight, mp[key][i].T
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
    """Copy the numpy JAX tree into ``model`` in place (each array cast to
    the parameter's device and dtype). Raises on an untied tree, on a shape
    mismatch, and when a parameter of the model is left unset."""
    check_tied(tree)
    seen = set()
    for param, arr in _pairs(model, tree):
        arr = np.asarray(arr)
        if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
            arr = arr.astype(np.float32)  # e.g. ml_dtypes bfloat16 (exact)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(
                f"shape mismatch: JAX {arr.shape} for a port parameter of "
                f"shape {tuple(param.shape)}"
            )
        param.copy_(torch.from_numpy(np.array(arr)))  # a writable copy
        seen.add(id(param))
    missing = [n for n, p in model.named_parameters() if id(p) not in seen]
    if missing:
        raise ValueError(f"parameters not set by the tree: {missing}")
    return model
