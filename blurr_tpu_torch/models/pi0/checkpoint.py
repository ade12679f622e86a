"""Pi-0 weights in and out of the port's ``PiZero``: a JAX parameter tree,
and the reference's ``.pt`` checkpoints.

**JAX trees.** Counterpart of the parameter layouts of ``blurr_tpu/models/pi0``
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
whose kind differs from the model's module there is refused. An adaptive
mixture's norms are ``{"to_gamma_w", "to_gamma_b", "to_beta_w"}`` dicts and
its adaLN-Zero gates ``post_scale`` / ``final_scale`` ``{"gamma_w",
"gamma_b"}``.

**Reference checkpoints.** Counterpart of the torch bridge of
``blurr_tpu/models/pi0/checkpoint.py`` (``load_torch_state_dict``,
``_siglip_params_from_torch``, ``_mixture_params_from_torch``,
``pizero_params_from_torch_checkpoint``, ``load_pizero_params_auto`` and the
exporters ``_siglip_state_from_params``, ``_mixture_state_from_params``,
``torch_state_dict_from_pizero_params``, ``save_torch_checkpoint``). The
reference's state dict (``{"model": state}``, keys maybe prefixed
``_orig_mod.``) names the reference's modules, whose linears are
``nn.Linear``s as the port's are: one key map (``_reference_keys``) serves
both directions, and only the SigLIP patch convolution [D, C, p, p] is
permuted into the port's [D, p*p*C] linear. Loading casts each fp32 tensor
to the model's device and dtype, as JAX casts the tree; writing gives fp32
CPU tensors. The port ties the proprio mixture to the action mixture, so a
checkpoint whose proprio tensors differ from its action tensors is refused
(JAX would serve it untied). An orbax directory (JAX ``save_params``) is
not read: it comes with the training port.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from blurr_tpu_torch.models.pi0.joint import AdaptiveLayerscale, AdaptiveRMSNorm
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.ops.quant import CachedFpLinear, Int8Linear, W4A8Linear, W8A8Linear

log = logging.getLogger(__name__)

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


def linear_pairs(mod, tree: Dict, w: str, b: str, i=None):
    """A linear's (weight, ``tree[w]``) and (bias, ``tree[b]``); ``i`` picks
    one layer of stacked leaves."""
    yield from _weight(mod, tree[w], i)
    yield mod.bias, tree[b] if i is None else tree[b][i]


def _norm(norm, leaf: Dict, i=None):
    """A mixture norm: Gemma's ``{"scale"}`` or adaLN's dict. ``i`` picks
    one layer of a stacked leaf."""
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    if isinstance(norm, AdaptiveRMSNorm):
        yield norm.to_gamma.weight, pick(leaf["to_gamma_w"]).T
        yield norm.to_gamma.bias, pick(leaf["to_gamma_b"])
        yield norm.to_beta.weight, pick(leaf["to_beta_w"]).T
    else:
        yield norm, pick(leaf["scale"])


def siglip_pairs(vt, sg: Dict) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """(port tensor, JAX array) of a SigLIP tower and its tree."""
    yield from linear_pairs(vt.patch_embedding, sg, "patch_w", "patch_b")
    yield vt.position_embedding, sg["pos_embed"]
    lp = sg["layers"]
    for i, layer in enumerate(vt.layers):
        for ln, key in ((layer.layer_norm1, "ln1"), (layer.layer_norm2, "ln2")):
            yield ln.weight, lp[f"{key}_w"][i]
            yield ln.bias, lp[f"{key}_b"][i]
        for key, attr in _SIGLIP_LAYER.items():
            yield from linear_pairs(getattr(layer, attr), lp, f"{key}_w", f"{key}_b", i)
    yield vt.post_layernorm.weight, sg["post_ln_w"]
    yield vt.post_layernorm.bias, sg["post_ln_b"]


def mixture_pairs(mixture, mp: Dict) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """(port tensor, JAX array) of a mixture and its stacked tree."""
    for i, layer in enumerate(mixture.layers):
        for key, attr in _MIXTURE_MATRICES.items():
            yield from _weight(getattr(layer, attr), mp[key], i)
        yield from _norm(layer.input_norm, mp["input_norm"], i)
        yield from _norm(layer.post_norm, mp["post_norm"], i)
        for key in ("post_scale", "final_scale"):
            gate = getattr(layer, key)
            if gate is not None:  # adaLN-Zero
                yield gate.gamma.weight, mp[key]["gamma_w"][i].T
                yield gate.gamma.bias, mp[key]["gamma_b"][i]
    if mixture.final_norm is not None:
        yield from _norm(mixture.final_norm, mp["final_norm"])


def _pairs(model: PiZero, tree: Dict) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """(port parameter, JAX array) for every parameter of the model."""
    yield model.embed_tokens, tree["embed_tokens"]
    yield from siglip_pairs(model.vision_tower, tree["siglip"])
    yield from linear_pairs(model.multi_modal_projector, tree["projector"], "w", "b")
    for name in ("vlm", "action"):
        yield from mixture_pairs(model.joint[name], tree["joint"][name])

    ae = tree["action_encoder"]
    yield from linear_pairs(model.action_encoder_w1, ae, "w1", "b1")
    yield from linear_pairs(model.action_encoder_w2, ae, "w2", "b2")
    yield from linear_pairs(model.action_encoder_w3, ae, "w3", "b3")
    yield from linear_pairs(model.proprio_encoder, tree["proprio_encoder"], "w", "b")
    yield from linear_pairs(model.action_decoder, tree["action_decoder"], "w", "b")


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
def copy_pairs(model: nn.Module, pairs: Iterable[Tuple[torch.Tensor, np.ndarray]]) -> None:
    """Copy each (port tensor, numpy array) pair in place (a float array
    cast to the tensor's device and dtype, int8 bytes copied as they are).
    Raises on a dtype kind or shape mismatch and when a parameter or buffer
    of ``model`` is left unset."""
    seen = set()
    for param, arr in pairs:
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


def load_jax_params(model: PiZero, tree: Dict) -> PiZero:
    """Copy the numpy JAX tree into ``model`` in place (``copy_pairs``).
    Raises on an untied tree, on a shape mismatch, on a quantized dict of
    another kind than the model's module, and when a parameter or buffer of
    the model is left unset."""
    check_tied(tree)
    copy_pairs(model, _pairs(model, tree))
    return model


# ---------------------------------------------------------------------------
# The reference's .pt checkpoints
# ---------------------------------------------------------------------------

_SIGLIP_PREFIX = "vision_tower.vision_model."
_PATCH_KEY = _SIGLIP_PREFIX + "embeddings.patch_embedding.weight"
_SIGLIP_LINEARS = {
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
    "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}
_MIXTURE_LINEARS = {
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
    "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
    "down_proj": "mlp.down_proj",
}


def _dense(key: str, mod, bias: bool = True) -> Iterator[Tuple[str, torch.Tensor]]:
    if type(mod) is not nn.Linear:
        raise ValueError(
            f"{key} is a {type(mod).__name__}: the reference checkpoint holds "
            "fp weights, so load or write it before quantizing"
        )
    yield key + ".weight", mod.weight
    if bias:
        yield key + ".bias", mod.bias


def _siglip_keys(vt, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Counterpart of JAX ``_siglip_params_from_torch``."""
    yield from _dense(prefix + "embeddings.patch_embedding", vt.patch_embedding)
    yield prefix + "embeddings.position_embedding.weight", vt.position_embedding
    for i, layer in enumerate(vt.layers):
        lp = f"{prefix}encoder.layers.{i}."
        for name in ("layer_norm1", "layer_norm2"):
            ln = getattr(layer, name)
            yield f"{lp}{name}.weight", ln.weight
            yield f"{lp}{name}.bias", ln.bias
        for attr, theirs in _SIGLIP_LINEARS.items():
            yield from _dense(lp + theirs, getattr(layer, attr))
    yield prefix + "post_layernorm.weight", vt.post_layernorm.weight
    yield prefix + "post_layernorm.bias", vt.post_layernorm.bias


def _norm_keys(key: str, norm) -> Iterator[Tuple[str, torch.Tensor]]:
    if isinstance(norm, AdaptiveRMSNorm):  # the reference's AdaptiveRMSNorm
        yield key + ".to_gamma.0.weight", norm.to_gamma.weight
        yield key + ".to_gamma.0.bias", norm.to_gamma.bias
        yield key + ".to_beta.weight", norm.to_beta.weight
    else:
        yield key + ".weight", norm


def _mixture_keys(mixture, prefix: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Counterpart of JAX ``_mixture_params_from_torch``, adaLN included."""
    for i, layer in enumerate(mixture.layers):
        lp = f"{prefix}layers.{i}."
        for attr, theirs in _MIXTURE_LINEARS.items():
            yield from _dense(lp + theirs, getattr(layer, attr), bias=False)
        yield from _norm_keys(lp + "input_layernorm", layer.input_norm)
        yield from _norm_keys(lp + "post_attention_layernorm", layer.post_norm)
        for attr, theirs in (("post_scale", "post_adaptive_scale"),
                             ("final_scale", "final_adaptive_scale")):
            gate = getattr(layer, attr)
            if isinstance(gate, AdaptiveLayerscale):
                yield from _dense(f"{lp}{theirs}.to_adaln_zero_gamma", gate.gamma)
    if mixture.final_norm is not None:
        yield from _norm_keys(prefix + "norm", mixture.final_norm)


def _reference_keys(model: PiZero) -> Iterator[Tuple[str, torch.Tensor]]:
    """(reference key, port tensor) for every tensor of the reference's
    Pi-0. The proprio keys name the action mixture's tensors (the tie)."""
    yield "embed_tokens.weight", model.embed_tokens
    yield from _siglip_keys(model.vision_tower, _SIGLIP_PREFIX)
    yield from _dense("multi_modal_projector.linear", model.multi_modal_projector)
    for name in ("vlm", "proprio", "action"):
        yield from _mixture_keys(model.joint[name], f"joint_model.mixtures.{name}.")
    for n in (1, 2, 3):
        yield from _dense(f"action_encoder.linear_{n}",
                          getattr(model, f"action_encoder_w{n}"))
    yield from _dense("proprio_encoder", model.proprio_encoder)
    yield from _dense("action_decoder", model.action_decoder)


def _patch_from_conv(w: torch.Tensor) -> torch.Tensor:
    """[D, C, p, p] conv weight -> the port's [D, p*p*C] ((pi, pj, c) order)."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _patch_to_conv(w: torch.Tensor) -> torch.Tensor:
    d, n = w.shape
    p = int(round((n // 3) ** 0.5))
    if p * p * 3 != n:
        raise ValueError(f"patch weight {tuple(w.shape)} is not [D, p*p*3]")
    return w.reshape(d, p, p, 3).permute(0, 3, 1, 2)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a reference ``.pt``: ``torch.load`` with
    ``weights_only`` (memory-mapped, on the CPU), the ``"model"`` entry when
    there is one, keys stripped of ``_orig_mod.`` (a compiled module's)."""
    data = torch.load(path, weights_only=True, map_location="cpu", mmap=True)
    state = data["model"] if isinstance(data, dict) and "model" in data else data
    return {k.replace("_orig_mod.", ""): v for k, v in state.items()}


@torch.no_grad()
def load_torch_checkpoint(model: PiZero, path: str) -> PiZero:
    """Counterpart of JAX ``pizero_params_from_torch_checkpoint``: copy a
    reference ``.pt`` into the unquantized ``model`` in place, each tensor
    cast to its parameter's device and dtype. Raises on a missing key, a
    shape mismatch, or proprio tensors that differ from the action ones;
    keys the port has no use for (e.g. a vlm final norm) are skipped, as
    JAX skips them."""
    state = load_torch_state_dict(path)
    missing = []
    loaded = {}  # id(parameter) -> its source, to check the tied mixtures
    for key, param in _reference_keys(model):
        if key not in state:
            missing.append(key)
            continue
        src = state[key]
        if key == _PATCH_KEY:
            src = _patch_from_conv(src)
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)}, "
                             f"model shape {tuple(param.shape)}")
        if id(param) in loaded:
            if not torch.equal(loaded[id(param)], src):
                raise ValueError(
                    f"{key} differs from the action mixture's: the checkpoint's "
                    "proprio mixture is not tied to its action mixture, and the "
                    "port always ties them"
                )
            continue
        param.copy_(src)
        loaded[id(param)] = src
    if missing:
        raise ValueError(f"{len(missing)} keys missing from {path}: {missing[:8]}")
    unread = state.keys() - {key for key, _ in _reference_keys(model)}
    if unread:
        log.info("%s: %d keys the port does not read", path, len(unread))
    return model


def load_checkpoint(model: PiZero, path: str) -> PiZero:
    """Counterpart of JAX ``load_pizero_params_auto``: a ``.pt`` file loads
    through ``load_torch_checkpoint``; a directory is an orbax tree, which
    the port does not read yet."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: an orbax parameter tree (JAX save_params) "
            "is read by the training port (ROADMAP M13), not yet; serve a "
            "reference .pt checkpoint"
        )
    return load_torch_checkpoint(model, path)


@torch.no_grad()
def torch_state_dict(model: PiZero) -> Dict[str, torch.Tensor]:
    """Counterpart of JAX ``torch_state_dict_from_pizero_params``: the
    reference's flat state dict of the unquantized ``model``, fp32 CPU
    tensors. The proprio keys hold the action mixture's tensors (one copy
    each, shared by the two keys, as a tied torch module's state dict)."""
    out, copies = {}, {}
    for key, param in _reference_keys(model):
        if id(param) not in copies:
            t = param.detach().to("cpu", torch.float32, copy=True)
            copies[id(param)] = _patch_to_conv(t).contiguous() if key == _PATCH_KEY else t
        out[key] = copies[id(param)]
    return out


def save_torch_checkpoint(model: PiZero, path: str) -> None:
    """Counterpart of JAX ``save_torch_checkpoint``: ``{"model": state}``
    with fp32 tensors, the format ``load_torch_state_dict`` reads."""
    torch.save({"model": torch_state_dict(model)}, path)


# ---------------------------------------------------------------------------
# PaliGemma's pretrained weights: HF safetensors
# ---------------------------------------------------------------------------

# the dtypes the reader and writer take: those of PaliGemma snapshots
_SAFETENSORS_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16, "F16": torch.float16}
_HEADER_ALIGN = 8  # the header is padded with spaces to this many bytes


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file, as CPU tensors over a
    private memory map of it (pages are read when a tensor is first used).
    The format: an 8-byte little-endian header length, a JSON header of
    ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (and an
    optional ``__metadata__``), then the raw little-endian bytes, the
    offsets counted from the end of the header."""
    import json
    import mmap

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} is {info['dtype']}; the reader takes "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        shape = info["shape"]
        if count != int(np.prod(shape)) or base + end > len(buf):
            raise ValueError(f"{path}: {name}'s offsets {begin, end} do not hold "
                             f"{info['dtype']} {shape}")
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin) if count \
            else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device; F32, BF16 or F16) as one
    ``.safetensors`` file in the layout ``read_safetensors`` reads."""
    import json

    codes = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    # wider elements first, so every tensor starts at a multiple of its
    # element size (the header's length is a multiple of 8)
    tensors = dict(sorted(tensors.items(), key=lambda kv: -kv[1].element_size()))
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in codes:
            raise ValueError(f"{name} is {t.dtype}; the writer takes {sorted(codes.values())}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % _HEADER_ALIGN)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            flat = t.detach().reshape(-1).view(torch.uint8).cpu()
            f.write(memoryview(flat.numpy()))


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Counterpart of JAX ``load_safetensors_dir``: the tensors of every
    ``*.safetensors`` file in ``path`` (sorted by name), without the
    ``safetensors`` package."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors file in {path}")
    tensors = {}
    for name in files:
        tensors.update(read_safetensors(os.path.join(path, name)))
    return tensors


def _paligemma_keys(embed_tokens, vision_tower, projector, vlm
                    ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(HF PaliGemma key, port tensor) of the token embedding, the SigLIP
    tower and the projector (where given) and the vlm mixture (its final
    norm where it has one): JAX ``paligemma_params_from_safetensors``'s
    map."""
    yield "language_model.model.embed_tokens.weight", embed_tokens
    if vision_tower is not None:
        yield from _siglip_keys(vision_tower, _SIGLIP_PREFIX)
        yield from _dense("multi_modal_projector.linear", projector)
    yield from _mixture_keys(vlm, "language_model.model.")


@torch.no_grad()
def load_paligemma_safetensors(embed_tokens, vision_tower, projector, vlm, path: str) -> None:
    """Counterpart of JAX ``paligemma_params_from_safetensors``: copy an HF
    PaliGemma snapshot's tensors (``path``, a directory of
    ``*.safetensors``) into the given modules in place, each cast to its
    parameter's device and dtype; the SigLIP patch convolution is permuted
    into the port's linear. Raises on a missing key or a shape mismatch;
    keys the port does not read (e.g. a vlm final norm the model lacks, an
    untied ``lm_head``) are skipped, as JAX skips them."""
    state = load_safetensors_dir(path)
    pairs = list(_paligemma_keys(embed_tokens, vision_tower, projector, vlm))
    missing = [key for key, _ in pairs if key not in state]
    if missing:
        raise ValueError(f"{len(missing)} keys missing from {path}: {missing[:8]}")
    for key, param in pairs:
        src = state[key]
        if key == _PATCH_KEY:
            src = _patch_from_conv(src)
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{key}: file shape {tuple(src.shape)}, "
                             f"model shape {tuple(param.shape)}")
        param.copy_(src)
    unread = state.keys() - {key for key, _ in pairs}
    if unread:
        log.info("%s: %d keys the port does not read", path, len(unread))


@torch.no_grad()
def paligemma_state_dict(embed_tokens, vision_tower, projector, vlm) -> Dict[str, torch.Tensor]:
    """The inverse of ``load_paligemma_safetensors``: the HF keys of the
    given modules, each tensor as it is (device and dtype), the patch
    linear as the HF convolution."""
    return {key: _patch_to_conv(t).contiguous() if key == _PATCH_KEY else t
            for key, t in _paligemma_keys(embed_tokens, vision_tower, projector, vlm)}
