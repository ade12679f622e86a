"""Pi-0 VLA model as an ``nn.Module``: the prefix-cached and the naive
control steps, and the text mode.

Counterpart of ``blurr_tpu/models/pi0/pizero.py`` (``PiZeroSpec``,
``spec_from_config``, ``PiZero`` with ``_embed_merge``,
``_encode_proprio``, ``_encode_action``, ``_time_embedding``,
``_decode_action``, ``infer_action``, ``infer_action_naive``,
``infer_action_from_frame``, which resizes raw camera frames on the device
first, ``infer_text_prefill``, ``infer_text_decode_step``,
``load_pretrained_weights`` and the training loss ``psi_t`` /
``flow_loss``). One cached control step:

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

The text mode runs the vlm mixture alone over image + prompt and then one
token at a time (``joint.single_forward``), with the tied embedding as its
head. ``materialize``, ``init_weights``, ``merge_embeds`` and the text
masks are shared with the standalone PaliGemma and Gemma models.
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
from blurr_tpu_torch.ops.embeddings import embedding, sinusoidal_pos_emb
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


def materialize(root: nn.Module, device) -> None:
    """Give every parameter of ``root`` (built on the meta device)
    uninitialized storage on ``device``: what ``root.to_empty(device=device)``
    does, without the Python meta-tensor code it runs (its first use imports
    sympy: seconds). Each module is visited once, so a tied module stays
    tied."""
    for mod in root.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            w = torch.empty(p.shape, dtype=p.dtype, device=device)
            setattr(mod, name, nn.Parameter(w))


@torch.no_grad()
def init_weights(root: nn.Module, generator: torch.Generator, embed_tokens: nn.Parameter,
                 vision_tower: Optional[SiglipVisionModel] = None) -> None:
    """Random weights drawn in place from ``generator``, with the JAX
    ``init_params`` distributions: dense weights N(0, 1/fan_in) (adaLN's
    ``to_gamma`` / ``to_beta`` too), biases and Gemma norm scales 0,
    LayerNorm scales 1, adaLN-Zero's gate weights 0 and biases -2; then the
    token embedding N(0, 1/hidden) and SigLIP's position embedding
    N(0, 1/width)."""

    def dense(w: torch.Tensor, fan_in: int):
        w.normal_(0.0, fan_in**-0.5, generator=generator)

    for mod in root.modules():
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
    for mod in root.modules():  # after the dense draws of their linears
        if isinstance(mod, joint_lib.AdaptiveLayerscale):
            mod.gamma.weight.zero_()
            mod.gamma.bias.fill_(-2.0)  # adaln_zero_bias_init
    dense(embed_tokens, embed_tokens.shape[1])
    if vision_tower is not None:
        pos = vision_tower.position_embedding
        dense(pos, pos.shape[1])


def merge_embeds(embed_tokens, feats, input_ids, image_token_index: int,
                 pad_token_id: int, hidden: int) -> torch.Tensor:
    """The token embeddings of ``input_ids`` with the projected image
    features ``feats`` [B, N, H], divided by sqrt(``hidden``), written at
    the image-token slots (always the first N positions of the prompt);
    pad tokens embed as 0."""
    text_embeds = embedding(input_ids, embed_tokens)
    # scalars are filled on the device (torch.full), never copied from
    # the host: such a copy waits for the stream, and the agent's async
    # pipeline relies on a step that never waits
    feats = feats / torch.full((), hidden**0.5, dtype=feats.dtype, device=feats.device)
    n_img = feats.shape[1]
    is_text = (input_ids != image_token_index) & (input_ids != pad_token_id)
    merged = torch.where(is_text[..., None], text_embeds, 0.0)
    img_mask_head = (input_ids[:, :n_img] == image_token_index)[..., None]
    head = torch.where(img_mask_head, feats.to(merged.dtype), merged[:, :n_img])
    return torch.cat([head, merged[:, n_img:]], dim=1)


def text_mask(valid: torch.Tensor, q_len: int, max_len: int) -> torch.Tensor:
    """bool [B, q_len, max_len], contiguous (the flash kernel's layout): a
    prefill's query rows see the prompt's columns (``cols < q_len``) that
    ``valid`` [B, q_len] marks; the columns past the prompt, which decode
    steps fill, are hidden."""
    cols = torch.arange(max_len, device=valid.device)
    seen = (cols < q_len) & F.pad(valid.bool(), (0, max_len - q_len), value=True)
    return seen[:, None].expand(-1, q_len, -1).contiguous()


def decode_mask(cache_len: int, max_len: int, batch: int, device,
                attn_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool [B, 1, max_len] of a decode step: the columns written so far
    (``cols <= cache_len``: the prompt and the tokens generated, this one
    included), without the prompt's pad slots that ``attn_valid``
    [B, prompt_len] marks invalid."""
    seen = torch.arange(max_len, device=device) <= cache_len
    if attn_valid is None:
        return seen.expand(batch, 1, max_len)
    valid = F.pad(attn_valid.bool(), (0, max_len - attn_valid.shape[1]), value=True)
    return (seen & valid)[:, None]


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
    flow_sig_min: float = 0.001


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
        flow_sig_min=float(cfg.get("flow_sig_min", 0.001)),
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
        materialize(self, device)

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

        init_weights(self, generator, self.embed_tokens, self.vision_tower)
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

    def _embed_merge(self, input_ids, pixel_values, remat: bool = False,
                     sp=None) -> torch.Tensor:
        """Text embedding with the scaled image features written at the
        image-token slots (always the first positions of the prompt).
        ``remat`` checkpoints each SigLIP layer (training). ``sp`` (a mesh
        with a seq axis): SigLIP runs on the rank's patch rows, the image
        features are put back together (``gather_sum_from_group``: the
        rank's patch and token slices need not line up) and the rank keeps
        its contiguous slice of the merged tokens."""
        s = self.spec
        feats = self.multi_modal_projector(self.vision_tower(pixel_values, remat=remat, sp=sp))
        if sp is not None and sp.seq > 1:
            from blurr_tpu_torch.parallel.mesh import gather_sum_from_group, sp_constrain

            feats = gather_sum_from_group(feats, sp.seq_group, 1)
            return sp_constrain(merge_embeds(self.embed_tokens, feats, input_ids,
                                             s.image_token_index, s.pad_token_id,
                                             self.vlm_hidden), sp)
        return merge_embeds(self.embed_tokens, feats, input_ids, s.image_token_index,
                            s.pad_token_id, self.vlm_hidden)

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

    # ------------------------------------------------------------------
    # Flow-matching training loss
    # ------------------------------------------------------------------

    def forward(self, *args, **kwargs) -> torch.Tensor:
        """The training forward is the loss, ``flow_loss`` (as the
        reference's ``PiZero.forward``)."""
        return self.flow_loss(*args, **kwargs)

    def psi_t(self, x: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The flow's point at time ``t`` [B] between noise ``x`` and the
        actions ``x1``: (1 - (1 - sig_min) t) x + t x1."""
        t = t[:, None, None]
        return (1 - (1 - self.spec.flow_sig_min) * t) * x + t * x1

    def flow_loss(
        self,
        input_ids: torch.Tensor,  # [B, S] int
        attention_mask: torch.Tensor,  # [B, S] int
        pixel_values: torch.Tensor,  # [B, C, H, W]
        proprios: torch.Tensor,  # [B, cond_steps, proprio_dim]
        actions: torch.Tensor,  # [B, horizon, action_dim]
        t: torch.Tensor,  # [B] flow time
        x0: torch.Tensor,  # noise, the shape of actions
        remat: bool = False,
        pipeline=None,
        sp=None,
    ) -> torch.Tensor:
        """The flow-matching loss (JAX ``PiZero.flow_loss``): the joint
        model's naive forward over image/text + proprio + the flow's point
        ``psi_t(x0, actions, t)`` (cast back to the actions' dtype), its
        velocity against ``actions - (1 - sig_min) x0``, the mean of the
        squares taken in fp32. ``t`` and ``x0`` are passed explicitly.
        ``remat`` recomputes each SigLIP and joint layer in the backward
        (``torch.utils.checkpoint``). The proprio mixture is the action
        module, so its gradient sums both mixtures' contributions, as JAX's
        canonical tied tree gives.

        ``pipeline`` (``parallel/pipeline.py:PipelineCtx``; the model cut by
        ``shard_params_pipeline``) runs the GPipe schedule over the pipe
        ranks: the batch in microbatches, each stage its joint layers, the
        loss the same on every stage (``pipelined_flow_loss``). ``sp`` (a
        mesh with a seq axis; JAX's ``sp_axis``) shards the SigLIP patches
        and the vlm tokens over the seq ranks (``_embed_merge``,
        ``flow_stage``); every rank returns the whole loss. The
        two use different meshes: together they raise JAX's
        ``ValueError``, before any collective."""
        if sp is not None and pipeline is not None:
            raise ValueError(
                "sequence parallelism (sp_axis) and pipeline parallelism use "
                "different meshes; compose sp with data/tensor axes instead"
            )
        inputs = (input_ids, attention_mask, pixel_values, proprios, actions, t, x0)
        if pipeline is not None:
            from blurr_tpu_torch.parallel.pipeline import pipelined_flow_loss

            return pipelined_flow_loss(self, inputs, pipeline, remat)
        return self.flow_stage(inputs, range(self.joint_spec.num_hidden_layers), remat=remat,
                               sp=sp)

    def _flow_error(self, hidden, actions, x0) -> torch.Tensor:
        """The mean squared error of the velocity decoded from the action
        mixture's final hidden states, in fp32."""
        v_psi = self._decode_action(hidden)
        d_psi = actions - (1 - self.spec.flow_sig_min) * x0
        return torch.mean((v_psi.float() - d_psi.float()) ** 2)

    def flow_stage(self, inputs, layers: range, carry=None, remat: bool = False, sp=None):
        """``flow_loss``'s joint layers ``layers`` on ``inputs`` (its seven
        arguments, or a pipeline microbatch's rows of them) over the hidden
        states ``carry`` (vlm, proprio, action; the embeddings when
        ``layers`` starts at 0). Returns the hidden states after them, or
        the loss after the model's last layer. The mask, the positions and
        the time conditioning are made here from ``inputs``' rows. ``sp``
        (a mesh with a seq axis): the vlm rows, their positions and their
        mask rows are the rank's contiguous slice of the tokens."""
        input_ids, attention_mask, pixel_values, proprios, actions, t, x0 = inputs
        s = self.spec
        names = ("vlm", "proprio", "action")
        time_emb = self._time_embedding(t).to(actions.dtype)
        time_cond = time_emb if s.adaptive_mode else None
        full_mask = mask_lib.pi0_full_mask(
            attention_mask, s.max_image_text_tokens, s.num_proprio_tokens,
            s.num_action_tokens,
        )
        positions = dict(zip(names, mask_lib.pi0_position_ids(
            input_ids.shape[0], s.max_image_text_tokens, s.num_proprio_tokens,
            s.num_action_tokens, device=input_ids.device,
        )))
        if sp is not None and sp.seq > 1:
            from blurr_tpu_torch.parallel.mesh import sp_constrain

            # the rank's queries: its slice of the vlm rows, then every other row
            n_vlm = s.max_image_text_tokens
            positions["vlm"] = sp_constrain(positions["vlm"], sp)
            full_mask = torch.cat([sp_constrain(full_mask[:, :n_vlm], sp),
                                   full_mask[:, n_vlm:]], dim=1)
        ropes, tcs = joint_lib.naive_consts(self.joint_spec, names, positions, time_cond)
        if layers.start == 0:
            psi = self.psi_t(x0, actions, t).to(actions.dtype)
            embeds = (self._embed_merge(input_ids, pixel_values, remat=remat, sp=sp),
                      self._encode_proprio(proprios), self._encode_action(psi, time_emb))
            carry = [joint_lib.scale_embeds(e) for e in embeds]
        hs, _ = joint_lib.naive_layers(self.joint, self.joint_spec, dict(zip(names, carry)),
                                       ropes, full_mask, tcs, layers, remat, sp=sp)
        if layers.stop < self.joint_spec.num_hidden_layers:
            return tuple(hs[n] for n in names)
        out = joint_lib.apply_norm(self.joint["action"].final_norm, hs["action"],
                                   tcs["action"], self.joint_spec.rms_norm_eps)
        return self._flow_error(out, actions, x0)

    # ------------------------------------------------------------------
    # Text generation (the vlm mixture alone, append-mode cache)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def infer_text_prefill(
        self,
        input_ids: torch.Tensor,  # [B, q_len] int
        pixel_values: torch.Tensor,  # [B, C, H, W]
        max_cache_len: int,
        attention_mask: Optional[torch.Tensor] = None,  # [B, q_len] validity
    ):
        """Prefill the vlm mixture over image + prompt; returns (logits
        [B, 1, V] of each row's last valid position, the cache, cache_len).

        The prompt attends bidirectionally at positions 1..q_len;
        ``attention_mask`` hides the pad slots of right-padded rows (omitted:
        all valid). The vlm's final norm applies where the config gives it
        one (bridge.yaml does not, and then none applies, as in JAX).
        ``cache_len`` is the host int q_len."""
        bsz, q_len = input_ids.shape
        embeds = self._embed_merge(input_ids, pixel_values)
        pos = torch.arange(1, q_len + 1, device=input_ids.device).expand(bsz, q_len)
        cache = joint_lib.alloc_single_cache(
            self.joint_spec, bsz, max_cache_len, embeds.dtype, embeds.device
        )
        valid = (torch.ones_like(input_ids, dtype=torch.bool) if attention_mask is None
                 else attention_mask)
        mask = text_mask(valid, q_len, max_cache_len)
        hidden, cache = joint_lib.single_forward(
            self.joint["vlm"], self.joint_spec, "vlm", embeds, pos, mask, cache, 0
        )
        # the tied head on each row's last valid position only (the full
        # [B, S, V] projection is ~155 MB of logits no caller reads)
        if attention_mask is None:
            h_last = hidden[:, -1:]
        else:
            last = attention_mask.long().sum(-1) - 1
            h_last = hidden.gather(1, last[:, None, None].expand(-1, 1, hidden.shape[-1]))
        return h_last @ self.embed_tokens.T, cache, q_len

    @torch.no_grad()
    def infer_text_decode_step(
        self,
        token: torch.Tensor,  # [B] or [B, 1]
        cache,
        cache_len: int,
        attn_valid: Optional[torch.Tensor] = None,  # [B, prompt_len] validity
    ):
        """One greedy decode step over the cache; returns (next token [B],
        the cache, cache_len + 1). For right-padded prompts ``attn_valid``
        hides the pad slots' cached K/V and corrects each row's RoPE
        position to ``cache_len + 1 - n_pad`` (its pad slots took prefill
        positions)."""
        logits, cache, cache_len = self.text_decode_logits(token, cache, cache_len, attn_valid)
        return logits[:, -1].argmax(-1), cache, cache_len

    @torch.no_grad()
    def text_decode_logits(self, token, cache, cache_len: int,
                           attn_valid: Optional[torch.Tensor] = None):
        """``infer_text_decode_step`` before its argmax: (logits [B, 1, V],
        the cache, cache_len + 1)."""
        if token.dim() == 1:
            token = token[:, None]
        bsz = token.shape[0]
        embeds = F.embedding(token, self.embed_tokens)
        mask = decode_mask(cache_len, cache[0].shape[3], bsz, token.device, attn_valid)
        if attn_valid is None:
            pos = torch.full((bsz, 1), cache_len + 1, device=token.device)
        else:
            n_pad = attn_valid.shape[1] - attn_valid.long().sum(-1)
            pos = (cache_len + 1 - n_pad)[:, None]
        hidden, cache = joint_lib.single_forward(
            self.joint["vlm"], self.joint_spec, "vlm", embeds, pos, mask, cache, cache_len
        )
        return hidden @ self.embed_tokens.T, cache, cache_len + 1

    def load_pretrained_weights(self, path: str) -> "PiZero":
        """PaliGemma's pretrained weights (the token embedding, SigLIP, the
        projector, the vlm mixture) from the HF safetensors files in
        ``path``, in place (``checkpoint.load_paligemma_safetensors``). The
        vlm's final norm loads only where this model has one."""
        from blurr_tpu_torch.models.pi0.checkpoint import load_paligemma_safetensors

        load_paligemma_safetensors(self.embed_tokens, self.vision_tower,
                                   self.multi_modal_projector, self.joint["vlm"], path)
        return self
