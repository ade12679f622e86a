"""GPTQ calibration for the Pi-0 joint mixtures.

Counterpart of ``blurr_tpu/models/pi0/calibrate.py`` (``WEIGHT_INPUTS``,
``collect_pi0_calibration``, ``gptq_quantize_mixture``,
``gptq_quantize_pi0``). The data-free w4a8 rounding minimizes each weight's
own error; GPTQ (``ops/gptq.py``) minimizes the layer output error on
calibration inputs taken from the model's own control loop:

1. ``collect_pi0_calibration`` replays the naive flow loop (every linear
   sees realistic inputs: vlm tokens of processed observations, action
   tokens at every flow time) through ``joint.naive_forward(capture=True)``,
   zeroes the padded vlm rows (a zero row adds nothing to X^T X) and stages
   the per-layer inputs on the host in fp32.
2. ``gptq_quantize_mixture`` moves a few layers' inputs at a time back to
   the device, builds their damped Hessians there and runs blocked GPTQ on
   the layers' ``nn.Linear`` weights, swapping each for the ``W4A8Linear``
   that ``ops/quant.py:quantize_mixture_w4a8`` would make (``int8_keys`` to
   ``W8A8Linear``), in place. The weights that share an input (q, k, v;
   gate, up) walk their rows together, concatenated along N: GPTQ treats
   every output column apart, so each weight gets the levels it would get
   alone.

The port holds the model's weights in the modules, so the functions take
the model and quantize it in place, where JAX takes and returns parameter
trees. The flow state runs in the model's dtype (JAX draws it in fp32 and
promotes bf16 weights to it); an fp32 model draws JAX's noise (``split``
chains of ``ops/prng.py``).

Weight -> input: q_w / k_w / v_w <- attn_in, o_w <- o_in, gate_w / up_w <-
mlp_in, down_w <- down_in.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from blurr_tpu_torch.models.pi0 import joint as joint_lib
from blurr_tpu_torch.ops import masks as mask_lib
from blurr_tpu_torch.ops import prng
from blurr_tpu_torch.ops.gptq import _gptq_levels, hessian_from_inputs, pack_levels
from blurr_tpu_torch.ops.int4_matmul import pick_group_size
from blurr_tpu_torch.ops.quant import (
    _QUANT_WEIGHT_KEYS,
    W4A8Linear,
    W8A8Linear,
    quantize_vit_w8a8,
)

# weight key -> captured input key (weights sharing an input share a Hessian)
WEIGHT_INPUTS = {
    "q_w": "attn_in",
    "k_w": "attn_in",
    "v_w": "attn_in",
    "o_w": "o_in",
    "gate_w": "mlp_in",
    "up_w": "mlp_in",
    "down_w": "down_in",
}
# device bytes the Hessians (and their factors) of one batch of layers may take
_HESSIAN_BYTES = 12 * 2**30


def _batch_tensors(batch: dict, device, dtype):
    """(ids, mask, pixel values, proprio) of one batch on ``device``, the
    floats in ``dtype``."""
    ids, am, px, pr = (torch.as_tensor(batch[k]) for k in
                       ("input_ids", "attention_mask", "pixel_values", "proprios"))
    return (ids.to(device), am.to(device), px.to(device, dtype), pr.to(device, dtype))


@torch.no_grad()
def collect_pi0_calibration(
    model,
    batches: List[Dict],
    num_flow_steps: int = 2,
    mixtures: tuple = ("vlm", "action"),
    seed: int = 0,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run the naive flow loop over calibration observations and return the
    host-staged per-layer linear inputs, ``{mixture: {input_key: fp32 CPU
    [L, T_total, K]}}``. ``model`` is a ``PiZero`` whose mixtures are still
    fp (calibration comes before quantization); ``batches`` are dicts of
    input_ids / attention_mask / pixel_values / proprios (numpy or tensors).
    The flow state advances with the model's own velocity between captured
    steps, so every flow time contributes action-token inputs."""
    s = model.spec
    device = model.embed_tokens.device
    dtype = model.embed_tokens.dtype
    out: Dict[str, Dict[str, list]] = {n: {} for n in mixtures}
    delta_t = 1.0 / num_flow_steps
    rng = prng.prng_key(seed)
    for batch in batches:
        ids, am, px, pr = _batch_tensors(batch, device, dtype)
        bsz = ids.shape[0]
        rng, sub = prng.split(rng)
        action = prng.normal(sub, (bsz, s.num_action_tokens, s.action_dim), torch.float32,
                             device).to(dtype)
        t = torch.zeros(bsz, dtype=dtype, device=device)
        full_mask = mask_lib.pi0_full_mask(am, s.max_image_text_tokens, s.num_proprio_tokens,
                                           s.num_action_tokens)
        vlm_pos, proprio_pos, action_pos = mask_lib.pi0_position_ids(
            bsz, s.max_image_text_tokens, s.num_proprio_tokens, s.num_action_tokens,
            device=device)
        inputs_embeds = model._embed_merge(ids, px)
        proprio_embeds = model._encode_proprio(pr)
        prefix_tc = model._time_cond(torch.zeros(bsz, dtype=dtype, device=device))
        valid = am.float()[None, :, :, None]  # [1, B, S_vlm, 1]
        for _ in range(num_flow_steps):
            time_emb = model._time_embedding(t).to(dtype)
            hidden, caps = joint_lib.naive_forward(
                model.joint, model.joint_spec,
                {"vlm": inputs_embeds, "proprio": proprio_embeds,
                 "action": model._encode_action(action, time_emb)},
                {"vlm": vlm_pos, "proprio": proprio_pos, "action": action_pos},
                full_mask, time_emb if s.adaptive_mode else None,
                prefix_time_cond=prefix_tc, capture=True,
            )
            vel = model._decode_action(hidden)
            # padded vlm rows must not enter the Hessians: zero rows add nothing
            caps["vlm"] = {k: x.float() * valid for k, x in caps["vlm"].items()}
            for n in mixtures:
                for key, x in caps[n].items():
                    # [L, B, S, K] -> host [L, B*S, K] fp32
                    out[n].setdefault(key, []).append(
                        x.float().reshape(x.shape[0], -1, x.shape[-1]).cpu())
            action = action + delta_t * vel
            t = t + delta_t
    return {n: {k: torch.cat(v, dim=1) for k, v in d.items()} for n, d in out.items()}


def _layer_chunks(n_layers: int, k: int) -> List[range]:
    """Consecutive layers whose Hessian, inverse and factor fit
    ``_HESSIAN_BYTES`` together."""
    per_layer = 3 * k * k * 4
    step = max(1, min(n_layers, _HESSIAN_BYTES // per_layer))
    return [range(i, min(i + step, n_layers)) for i in range(0, n_layers, step)]


@torch.no_grad()
def gptq_quantize_mixture(
    layers: Sequence[nn.Module],
    calib: Dict[str, torch.Tensor],
    group_size: int = 512,
    int8_keys: tuple = (),
    damp: float = 0.01,
) -> None:
    """``quantize_mixture_w4a8``'s GPTQ twin, in place: every mixture linear
    of ``layers`` that is still an ``nn.Linear`` becomes a ``W4A8Linear``
    rounded with error feedback against its own layer's calibration Hessian
    (``calib[input_key]`` [L, T, K] on the host), or a ``W8A8Linear`` where
    its JAX name is in ``int8_keys``."""
    layers = list(layers)
    by_input: Dict[str, List[str]] = {}
    for key, attr in _QUANT_WEIGHT_KEYS.items():
        if not isinstance(getattr(layers[0], attr), nn.Linear):
            continue
        if key in int8_keys:
            for layer in layers:
                setattr(layer, attr, W8A8Linear.from_linear(getattr(layer, attr)))
            continue
        by_input.setdefault(WEIGHT_INPUTS[key], []).append(attr)
    for input_key, attrs in by_input.items():
        x_all = calib[input_key]
        k = x_all.shape[-1]
        gs = pick_group_size(k, group_size)
        for chunk in _layer_chunks(len(layers), k):
            device = getattr(layers[chunk[0]], attrs[0]).weight.device
            widths = [getattr(layers[chunk[0]], a).out_features for a in attrs]
            # [C, K, sum N]: each layer's weights of this input side by side
            w = torch.stack([torch.cat([getattr(layers[i], a).weight.t() for a in attrs], dim=1)
                             for i in chunk]).float()
            h = hessian_from_inputs(x_all[chunk.start:chunk.stop].to(device), damp=damp)
            q, s = _gptq_levels(w, h, gs)
            del h, w
            for j, i in enumerate(chunk):
                for a, q_a, s_a in zip(attrs, q[j].split(widths, dim=1),
                                       s[j].split(widths, dim=1)):
                    setattr(layers[i], a, W4A8Linear(**pack_levels(q_a, s_a)))
            del q, s


@torch.no_grad()
def gptq_quantize_pi0(
    model,
    batches: List[Dict],
    num_flow_steps: int = 2,
    group_size: Optional[int] = None,
    seed: int = 0,
):
    """The GPTQ twin of ``enable_vlm_quantization`` +
    ``enable_action_quantization`` for the w4a8 presets, in place: calibrate
    on ``batches`` (the mixtures still fp), then quantize the vlm and action
    mixtures with GPTQ-w4a8 under the cfg's group_size / int8_keys knobs,
    and SigLIP to w8a8 under ``include_vision``. The proprio mixture is the
    action mixture's module (the port refuses untied checkpoints), so its
    inputs join the action Hessians, as JAX does for a tied tree. Returns
    the model, which then serves through the int4 kernel as the data-free
    tiers leave it."""
    calib = collect_pi0_calibration(model, batches, num_flow_steps=num_flow_steps, seed=seed,
                                    mixtures=("vlm", "action", "proprio"))
    # the tied weights process the proprio tokens too
    calib["action"] = {k: torch.cat([v, calib["proprio"][k]], dim=1)
                       for k, v in calib["action"].items()}
    for n in ("vlm", "action"):
        gs = group_size
        if gs is None:
            gs = model.vlm_w4a8_group_size if n == "vlm" else model.action_w4a8_group_size
        keys = model.vlm_w4a8_int8_keys if n == "vlm" else model.action_w4a8_int8_keys
        gptq_quantize_mixture(model.joint[n].layers, calib[n], group_size=gs, int8_keys=keys)
    if model.vlm_quant_vision:
        quantize_vit_w8a8(model.vision_tower.layers)
    return model
