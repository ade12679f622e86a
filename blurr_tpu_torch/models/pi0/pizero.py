"""Pi-0 VLA model as an ``nn.Module``: the prefix-cached and the naive
control steps.

Counterpart of ``blurr_tpu/models/pi0/pizero.py`` (``PiZeroSpec``,
``spec_from_config``, ``PiZero`` with ``_embed_merge``,
``_encode_proprio``, ``_encode_action``, ``_time_embedding``,
``_decode_action``, ``infer_action``, ``infer_action_naive`` and
``infer_action_from_frame``, which resizes raw camera frames on the device
first). One cached control step:

    embed merge (SigLIP + projector) -> proprio encoder
    -> joint prefill over the image/text + proprio prefix (KV cache)
    -> num_inference_steps Euler steps: action encoder -> joint decode of
       the action tokens over the cache -> action decoder
    -> clip

The naive step (the ``baseline`` preset) runs the whole joint model over
image/text + proprio + action in each flow step, with the full block mask.

The proprio mixture IS the action mixture module (the JAX package's
``tie_action_proprio_weights``). The quantization tiers are in-place
methods: ``enable_action_quantization`` (int8 weight-only or cached-fp,
w8a8, w4a8) and ``enable_vlm_quantization`` (w8a8, w4a8). The int8 KV cache
quantizes the prefix cache after the prefill. Under
``action_expert_adaptive_mode`` (adaLN, adaLN-Zero) the action expert's
norms are conditioned on the flow time's embedding of width
``time_hidden_size`` instead of the action encoder concatenating it; the
prefix, cached or frozen, is conditioned on t=0's.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.models.pi0 import joint as joint_lib
from blurr_tpu_torch.models.pi0.joint import JointSpec, Mixture
from blurr_tpu_torch.models.pi0.processing import IMAGENET_STANDARD_MEAN, IMAGENET_STANDARD_STD
from blurr_tpu_torch.models.pi0.siglip import SiglipVisionModel, projector
from blurr_tpu_torch.ops import masks as mask_lib
from blurr_tpu_torch.ops.activations import silu
from blurr_tpu_torch.ops.embeddings import sinusoidal_pos_emb
from blurr_tpu_torch.ops.quant import (
    linear,
    quantize_dense_int8,
    quantize_kv_int8,
    quantize_mixture_int8,
    quantize_mixture_w4a8,
    quantize_mixture_w8a8,
    quantize_vit_w8a8,
)
from blurr_tpu_torch.utils.image import lanczos_resize

log = logging.getLogger(__name__)

# the modes the JAX package knows, per quantization key (all ported)
_QUANT_MODES = {
    "action_quantization": {"int8", "int8_cached", "bnb_int8", "w8a8", "w4a8"},
    "vlm_quantization": {"w8a8", "w4a8"},
    "kv_quantization": {"int8"},
}
# kv_quantization.dtype, the dtype the int8 cache is dequantized to ('' ->
# the action dtype); float16 becomes bfloat16, as in the JAX package
_KV_DTYPES = {"": None, "bfloat16": torch.bfloat16, "float32": torch.float32,
              "float16": torch.bfloat16}
_ACTION_ENCODER = ("action_encoder_w1", "action_encoder_w2", "action_encoder_w3")


def _checked_mode(qcfg: dict, name: str) -> Optional[str]:
    """Normalized quantization mode of config key ``name``: ''/'none' ->
    None. An unknown mode raises ValueError, as in the JAX package."""
    mode = str(qcfg.get("mode") or "").lower()
    if mode in ("", "none"):
        return None
    allowed = _QUANT_MODES[name]
    if mode not in allowed:
        raise ValueError(
            f"{name}.mode {mode!r} is not supported; expected one of "
            f"{sorted(allowed)} (or empty to disable)"
        )
    return mode


def _kv_dequant_dtype(kq: dict) -> Optional[torch.dtype]:
    """``kv_quantization.dtype`` as the JAX ``PiZero`` reads it, whatever
    the mode: '', bfloat16, float32 (with or without a ``torch.`` prefix),
    float16 -> bfloat16 with a warning; anything else raises ValueError."""
    name = str(kq.get("dtype") or "").lower().removeprefix("torch.")
    if name not in _KV_DTYPES:
        raise ValueError(
            f"kv_quantization.dtype={kq['dtype']!r} unsupported "
            "(bfloat16/float32/float16)"
        )
    if name == "float16":
        log.warning("kv_quantization.dtype=float16 -> bfloat16 (the JAX "
                    "package's mapping: dequantized KV chunks get bf16 numerics)")
    return _KV_DTYPES[name]


def _quantize_cache(cache, clip: Optional[float]):
    """The int8 KV cache: per layer an ``Int8KV``, k and v int8 with one
    fp32 scale per (batch, head) each, as JAX's ``infer_action`` quantizes
    the stacked cache."""
    out = []
    for k, v in cache:
        (k_q, k_s), (v_q, v_s) = quantize_kv_int8(k, clip), quantize_kv_int8(v, clip)
        out.append(joint_lib.Int8KV(k_q, v_q, k_s, v_s))
    return out


@dataclass(frozen=True)
class PiZeroSpec:
    max_image_text_tokens: int
    num_proprio_tokens: int  # cond_steps
    num_action_tokens: int  # horizon_steps
    action_dim: int
    proprio_dim: int
    num_inference_steps: int
    final_action_clip_value: Optional[float]
    image_token_index: int
    pad_token_id: int
    vocab_size: int
    time_max_period: float
    adaptive_mode: Optional[str]
    time_hidden_size: int


def spec_from_config(cfg: dict) -> PiZeroSpec:
    """The fields of the JAX ``spec_from_config`` that the control steps
    read. Checks the quantization modes (``_checked_mode``)."""
    for key in _QUANT_MODES:
        _checked_mode(cfg.get(key) or {}, key)
    return PiZeroSpec(
        max_image_text_tokens=cfg["max_image_text_tokens"],
        num_proprio_tokens=cfg["cond_steps"],
        num_action_tokens=cfg["horizon_steps"],
        action_dim=cfg["action_dim"],
        proprio_dim=cfg["proprio_dim"],
        num_inference_steps=cfg["num_inference_steps"],
        final_action_clip_value=cfg.get("final_action_clip_value"),
        image_token_index=cfg["image_token_index"],
        pad_token_id=cfg["pad_token_id"],
        vocab_size=cfg["vocab_size"],
        time_max_period=float(cfg.get("time_max_period", 10000.0)),
        adaptive_mode=cfg.get("action_expert_adaptive_mode") or None,
        time_hidden_size=int(cfg.get("time_hidden_size", 256) or 256),
    )


class PiZero(nn.Module):
    """Pi-0 with random or loaded weights on an explicit device and dtype.

    The modules are built on the meta device and then given uninitialized
    storage on ``device``: no default initialization runs (it would draw
    3B values, from the process-wide generator). Set the weights with
    ``init_params`` or ``checkpoint.load_jax_params`` before use.
    Weight names follow the PyTorch habit (``nn.Linear`` stores [out, in]);
    ``load_jax_params`` maps a JAX parameter tree onto them.
    """

    def __init__(self, cfg: dict, *, device, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.spec = s = spec_from_config(cfg)
        self.joint_spec = JointSpec.from_config(dict(cfg["joint"]["config"]))
        self.vision_cfg = dict(cfg["vision"]["config"])
        # quantization (the JAX PiZero's mode fields)
        aq = cfg.get("action_quantization") or {}
        vq = cfg.get("vlm_quantization") or {}
        kq = cfg.get("kv_quantization") or {}
        self.action_quant_mode = _checked_mode(aq, "action_quantization")
        # the int8 modes' cached-fp copy is bf16 whatever the model dtype:
        # JAX passes no fp_dtype, so action_quantization.fp_dtype is unread
        self.action_quant_cache_fp = bool(aq.get("cache_fp_weight", False))
        self.action_w4a8_group_size = int(aq.get("group_size", 512) or 512)
        self.action_w4a8_int8_keys = tuple(aq.get("int8_keys") or ())
        self.vlm_quant_mode = _checked_mode(vq, "vlm_quantization")
        self.vlm_quant_vision = bool(vq.get("include_vision", False))
        self.vlm_w4a8_group_size = int(vq.get("group_size", 512) or 512)
        self.vlm_w4a8_int8_keys = tuple(vq.get("int8_keys") or ())
        self.kv_quant_mode = _checked_mode(kq, "kv_quantization")
        clip = kq.get("activation_clip")
        self.kv_quant_clip = float(clip) if clip is not None else None
        self.kv_dequant_dtype = _kv_dequant_dtype(kq)
        # activation clips are per mixture: the action clip goes to the
        # action and proprio mixtures, the vlm clip to the vlm mixture, each
        # only when its tier is on. The action encoder takes the action clip
        # too, as in JAX (it bites where the int8 tiers quantize it).
        a_clip = self._clip(aq, self.action_quant_mode)
        v_clip = self._clip(vq, self.vlm_quant_mode)
        self.encoder_activation_clip = a_clip
        mixtures = dict(self.joint_spec.mixtures)
        for name, c in (("action", a_clip), ("proprio", a_clip), ("vlm", v_clip)):
            if c is not None and name in mixtures:
                mixtures[name] = dataclasses.replace(mixtures[name], activation_clip=c)
        self.joint_spec = dataclasses.replace(self.joint_spec, mixtures=mixtures)
        mix = self.joint_spec.mixtures
        if mix["proprio"] != mix["action"]:
            raise ValueError(
                "the proprio mixture is tied to the action mixture, so their "
                f"specs must be equal: {mix['proprio']} vs {mix['action']}"
            )
        self.vlm_hidden = mix["vlm"].hidden_size
        self.action_hidden = aw = mix["action"].hidden_size
        kw = dict(device="meta", dtype=dtype)

        # a plain parameter, not nn.Embedding: the default init of that
        # (normal_) runs Python meta-tensor code too
        self.embed_tokens = nn.Parameter(
            torch.empty(s.vocab_size, self.vlm_hidden, **kw)
        )
        self.vision_tower = SiglipVisionModel(self.vision_cfg, **kw)
        self.multi_modal_projector = projector(
            dict(cfg["vision_projector"]["config"]), **kw
        )
        self.joint = nn.ModuleDict({
            "vlm": Mixture(mix["vlm"], self.joint_spec, **kw),
            "action": Mixture(mix["action"], self.joint_spec, **kw),
        })
        self.joint["proprio"] = self.joint["action"]  # tied: one module
        # action encoder: the time embedding (action width) is concatenated
        # FIRST, then the projected action; an adaptive expert takes the
        # time through its norms instead, so its w2 is square
        self.action_encoder_w1 = nn.Linear(s.action_dim, aw, **kw)
        time_cond_in = aw if s.adaptive_mode else 2 * aw
        self.action_encoder_w2 = nn.Linear(time_cond_in, aw, **kw)
        self.action_encoder_w3 = nn.Linear(aw, aw, **kw)
        self.proprio_encoder = nn.Linear(
            s.proprio_dim, mix["proprio"].hidden_size, **kw
        )
        self.action_decoder = nn.Linear(aw, s.action_dim, **kw)
        # what ``self.to_empty(device=device)`` does, without the Python
        # meta-tensor code it runs (its first use imports sympy: seconds)
        for mod in self.modules():  # each module once: the tie survives
            for name, p in list(mod.named_parameters(recurse=False)):
                w = torch.empty(p.shape, dtype=p.dtype, device=device)
                setattr(mod, name, nn.Parameter(w))

    @staticmethod
    def _clip(qcfg: dict, mode: Optional[str]) -> Optional[float]:
        c = qcfg.get("activation_clip")
        return float(c) if (mode is not None and c is not None) else None

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "PiZero":
        """Random weights drawn in place, on the parameters' device and in
        their dtype, from ``generator`` (which lives on that device): dense
        weights N(0, 1/fan_in) (adaLN's ``to_gamma`` / ``to_beta`` too),
        biases and Gemma norm scales 0, LayerNorm scales 1, adaLN-Zero's gate
        weights 0 and biases -2 — the JAX ``init_params`` distributions."""

        def dense(w: torch.Tensor, fan_in: int):
            w.normal_(0.0, fan_in**-0.5, generator=generator)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                dense(mod.weight, mod.in_features)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (joint_lib.MixtureLayer, Mixture)):
                for p in mod.parameters(recurse=False):
                    p.zero_()
        for mod in self.modules():  # after the dense draws of their linears
            if isinstance(mod, joint_lib.AdaptiveLayerscale):
                mod.gamma.weight.zero_()
                mod.gamma.bias.fill_(-2.0)  # adaln_zero_bias_init
        dense(self.embed_tokens, self.vlm_hidden)
        pos = self.vision_tower.position_embedding
        dense(pos, pos.shape[1])
        return self

    @torch.no_grad()
    def enable_action_quantization(self) -> "PiZero":
        """Quantize the action mixture in place under
        ``action_quantization.mode`` (the proprio mixture is the same
        module). w8a8 and w4a8 quantize the mixture only. The int8 modes
        (int8, int8_cached and bnb_int8 alike, as in JAX) quantize the
        mixture and the action encoder's three linears, to ``Int8Linear`` or,
        under ``cache_fp_weight``, to a bf16 ``CachedFpLinear``. The proprio
        encoder and the action decoder stay fp, as in the JAX package."""
        layers = self.joint["action"].layers
        mode = self.action_quant_mode
        if mode == "w8a8":
            quantize_mixture_w8a8(layers)
        elif mode == "w4a8":
            quantize_mixture_w4a8(
                layers, self.action_w4a8_group_size, self.action_w4a8_int8_keys
            )
        elif mode is not None:
            quantize_mixture_int8(layers, self.action_quant_cache_fp)
            quantize_dense_int8([self], _ACTION_ENCODER, self.action_quant_cache_fp)
        return self

    @torch.no_grad()
    def enable_vlm_quantization(self) -> "PiZero":
        """Quantize the vlm mixture in place under a w8a8 or w4a8
        ``vlm_quantization.mode``; with ``include_vision`` the SigLIP layer
        linears go to w8a8 (under w4a8 too). The projector and the token
        embedding stay fp."""
        if self.vlm_quant_mode is None:
            return self
        layers = self.joint["vlm"].layers
        if self.vlm_quant_mode == "w8a8":
            quantize_mixture_w8a8(layers)
        else:
            quantize_mixture_w4a8(
                layers, self.vlm_w4a8_group_size, self.vlm_w4a8_int8_keys
            )
        if self.vlm_quant_vision:
            quantize_vit_w8a8(self.vision_tower.layers)
        return self

    # ------------------------------------------------------------------
    # Encoders
    # ------------------------------------------------------------------

    def _embed_merge(self, input_ids, pixel_values) -> torch.Tensor:
        """Text embedding with the scaled image features written at the
        image-token slots (always the first positions of the prompt)."""
        s = self.spec
        text_embeds = F.embedding(input_ids, self.embed_tokens)
        feats = self.multi_modal_projector(self.vision_tower(pixel_values))
        # scalars are filled on the device (torch.full), never copied from
        # the host: such a copy waits for the stream, and the agent's async
        # pipeline relies on a step that never waits
        feats = feats / torch.full(
            (), self.vlm_hidden**0.5, dtype=feats.dtype, device=feats.device
        )
        n_img = feats.shape[1]
        text_mask = (input_ids != s.image_token_index) & (
            input_ids != s.pad_token_id
        )
        merged = torch.where(text_mask[..., None], text_embeds, 0.0)
        img_mask_head = (input_ids[:, :n_img] == s.image_token_index)[..., None]
        head = torch.where(img_mask_head, feats.to(merged.dtype), merged[:, :n_img])
        return torch.cat([head, merged[:, n_img:]], dim=1)

    def _encode_proprio(self, proprios: torch.Tensor) -> torch.Tensor:
        return self.proprio_encoder(proprios)

    def _encode_action(self, action, time_emb) -> torch.Tensor:
        """3-layer MLP; the non-adaptive expert concatenates the time
        embedding first."""
        clip = self.encoder_activation_clip
        emb = linear(self.action_encoder_w1, action, clip)
        if self.spec.adaptive_mode is None:
            t_full = time_emb[:, None, :].expand(-1, emb.shape[1], -1)
            emb = torch.cat([t_full, emb], dim=-1)
        emb = silu(linear(self.action_encoder_w2, emb, clip))
        return linear(self.action_encoder_w3, emb, clip)

    def _time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        s = self.spec
        dim = s.time_hidden_size if s.adaptive_mode else self.action_hidden
        return sinusoidal_pos_emb(t, dim, s.time_max_period)

    def _time_cond(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        """An adaptive expert's conditioning at time ``t`` (model dtype);
        None for the non-adaptive expert."""
        if self.spec.adaptive_mode is None:
            return None
        return self._time_embedding(t).to(t.dtype)

    def _decode_action(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.action_decoder(hidden)

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------

    @torch.no_grad()
    def infer_action(
        self,
        input_ids: torch.Tensor,  # [B, S] int
        attention_mask: torch.Tensor,  # [B, S] int
        pixel_values: torch.Tensor,  # [B, C, H, W] preprocessed floats
        proprios: torch.Tensor,  # [B, cond_steps, proprio_dim]
        noise: torch.Tensor,  # [B, horizon, action_dim]
        num_inference_steps: Optional[int] = None,
    ) -> torch.Tensor:
        """Prefix-cached flow integration; ``noise`` is passed explicitly."""
        s = self.spec
        steps = num_inference_steps or s.num_inference_steps
        bsz = input_ids.shape[0]
        prefix_mask = mask_lib.pi0_prefix_mask(
            attention_mask, s.max_image_text_tokens, s.num_proprio_tokens
        )
        action_mask = mask_lib.pi0_action_mask(
            attention_mask, s.max_image_text_tokens, s.num_proprio_tokens,
            s.num_action_tokens,
        )
        vlm_pos, proprio_pos, action_pos = mask_lib.pi0_position_ids(
            bsz, s.max_image_text_tokens, s.num_proprio_tokens,
            s.num_action_tokens, device=input_ids.device,
        )
        cache = joint_lib.prefill(
            {"vlm": self.joint["vlm"], "proprio": self.joint["proprio"]},
            self.joint_spec,
            {
                "vlm": self._embed_merge(input_ids, pixel_values),
                "proprio": self._encode_proprio(proprios),
            },
            {"vlm": vlm_pos, "proprio": proprio_pos},
            prefix_mask,
            # a cached adaptive prefix holds for one conditioning: t=0's
            time_cond=self._time_cond(torch.zeros(bsz, dtype=noise.dtype,
                                                  device=noise.device)),
        )
        if self.kv_quant_mode == "int8":
            cache = _quantize_cache(cache, self.kv_quant_clip)
        # t and the step size live in the MODEL dtype, as in JAX (and the
        # reference's Euler loop): bf16 presets carry bf16 time
        dtype = noise.dtype
        delta_t = torch.full((), 1.0 / steps, dtype=dtype, device=noise.device)
        action = noise
        t = torch.zeros(bsz, dtype=dtype, device=noise.device)
        for _ in range(steps):
            time_emb = self._time_embedding(t).to(dtype)
            hidden = joint_lib.decode(
                self.joint["action"], self.joint_spec,
                self._encode_action(action, time_emb), action_pos, cache,
                action_mask, self.kv_dequant_dtype,
                time_emb if s.adaptive_mode else None,
            )
            action = action + delta_t * self._decode_action(hidden)
            t = t + delta_t
        return self._clip_actions(action)

    @torch.no_grad()
    def infer_action_from_frame(
        self,
        input_ids: torch.Tensor,  # [B, S] int
        attention_mask: torch.Tensor,  # [B, S] int
        frame: torch.Tensor,  # raw camera frames [B, H, W, 3] uint8
        proprios: torch.Tensor,  # [B, cond_steps, proprio_dim]
        noise: torch.Tensor,  # [B, horizon, action_dim]
        num_inference_steps: Optional[int] = None,
    ) -> torch.Tensor:
        """The control step from raw camera frames: the resize and the
        rescale/normalize run on the frames' device ahead of the encoder,
        as JAX's ``infer_action_from_frame`` runs them in-graph
        (``jax.image.resize`` lanczos3, antialiased, fp32; then
        ``(x / 255 - 0.5) / 0.5``, NCHW, the proprio dtype). The resize's
        products are fp32 matmuls, so TF32 must be off on a card."""
        if frame.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("infer_action_from_frame resizes in fp32: TF32 must be "
                               "off (torch.backends.cuda.matmul.allow_tf32)")
        size = self.vision_cfg["image_size"]
        x = lanczos_resize(frame.float(), size, size, radius=3)
        x = (x / 255.0 - IMAGENET_STANDARD_MEAN) / IMAGENET_STANDARD_STD
        pixel_values = x.permute(0, 3, 1, 2).to(proprios.dtype)
        return self.infer_action(input_ids, attention_mask, pixel_values, proprios,
                                 noise, num_inference_steps)

    @torch.no_grad()
    def infer_action_naive(
        self,
        input_ids: torch.Tensor,  # [B, S] int
        attention_mask: torch.Tensor,  # [B, S] int
        pixel_values: torch.Tensor,  # [B, C, H, W] preprocessed floats
        proprios: torch.Tensor,  # [B, cond_steps, proprio_dim]
        noise: torch.Tensor,  # [B, horizon, action_dim]
        num_inference_steps: Optional[int] = None,
    ) -> torch.Tensor:
        """No-cache flow integration: each flow step runs the whole joint
        model (``joint.naive_forward``) over image/text + proprio + action
        with the full block mask. Same Euler loop, time dtype and clip as
        ``infer_action``; an adaptive prefix stays conditioned on t=0."""
        s = self.spec
        steps = num_inference_steps or s.num_inference_steps
        bsz = input_ids.shape[0]
        full_mask = mask_lib.pi0_full_mask(
            attention_mask, s.max_image_text_tokens, s.num_proprio_tokens,
            s.num_action_tokens,
        )
        vlm_pos, proprio_pos, action_pos = mask_lib.pi0_position_ids(
            bsz, s.max_image_text_tokens, s.num_proprio_tokens,
            s.num_action_tokens, device=input_ids.device,
        )
        inputs_embeds = self._embed_merge(input_ids, pixel_values)
        proprio_embeds = self._encode_proprio(proprios)
        dtype = noise.dtype
        delta_t = torch.full((), 1.0 / steps, dtype=dtype, device=noise.device)
        action = noise
        t = torch.zeros(bsz, dtype=dtype, device=noise.device)
        prefix_tc = self._time_cond(t)
        for _ in range(steps):
            time_emb = self._time_embedding(t).to(dtype)
            hidden = joint_lib.naive_forward(
                self.joint, self.joint_spec,
                {"vlm": inputs_embeds, "proprio": proprio_embeds,
                 "action": self._encode_action(action, time_emb)},
                {"vlm": vlm_pos, "proprio": proprio_pos, "action": action_pos},
                full_mask, time_emb if s.adaptive_mode else None,
                prefix_time_cond=prefix_tc,
            )
            action = action + delta_t * self._decode_action(hidden)
            t = t + delta_t
        return self._clip_actions(action)

    def _clip_actions(self, action: torch.Tensor) -> torch.Tensor:
        c = self.spec.final_action_clip_value
        return action if c is None else torch.clamp(action, -c, c)
