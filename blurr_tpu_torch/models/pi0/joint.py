"""Joint mixture transformer: prefill of the prefix and decode of the actions.

Counterpart of ``blurr_tpu/models/pi0/joint.py`` (``JointSpec``,
``MixtureSpec``, ``_attention``, ``prefill``, ``decode``). The mixtures
(vlm, proprio, action expert) share one attention pattern per layer and
keep their own weights. JAX stacks the layers on a leading [L, ...] axis
and scans them; here each layer is an ``nn.Module`` in an ``nn.ModuleList``
and the walk is a Python loop. The KV cache is a list of per-layer (k, v)
pairs [B, KVH, P, D], with K stored after RoPE; the int8 KV cache holds
(k, v, k_scale, v_scale) per layer instead (``ops/quant.py:quantize_kv_int8``),
dequantized inside each layer of each decode step.

Numerics kept from JAX: embeds scaled by sqrt(hidden) rounded in the
compute dtype, Gemma RMSNorm, fp32 RoPE, the tanh soft clamp 50. The last
prefill layer computes only K/V: its attention and MLP output is never read.
A layer's linears are ``nn.Linear``s or, once a mixture is quantized, the
int8 / cached-fp / w8a8 / w4a8 modules of ``ops/quant.py``; each mixture
clamps the activations of its quantized linears with its own
``activation_clip`` (JAX ``_clip_for``).
The adaptive (adaLN) mixtures are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from blurr_tpu_torch.ops.activations import geglu
from blurr_tpu_torch.ops.attention import (
    DEFAULT_SOFTCLAMP,
    grouped_attention,
    merge_heads,
    split_heads,
)
from blurr_tpu_torch.ops.flash_attention import flash_attention
from blurr_tpu_torch.ops.norms import rms_norm
from blurr_tpu_torch.ops.quant import dequantize_kv, linear
from blurr_tpu_torch.ops.rotary import apply_rope, rope_cos_sin


class Int8KV(NamedTuple):
    """One layer of the int8 KV cache: int8 k and v, and their fp32 scales."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor


# per layer (k, v), or an ``Int8KV``
KVCache = List[Sequence[torch.Tensor]]

# below this many query rows the prefill keeps the plain attention, as the
# JAX dispatcher does (a small query block does not amortize the kernel)
FLASH_MIN_QUERIES = 64


@dataclass(frozen=True)
class MixtureSpec:
    hidden_size: int
    intermediate_size: int
    rope_theta: float = 10000.0
    use_final_norm: bool = False
    # clamp before this mixture's quantized matmuls (PiZero sets it from
    # the action / vlm quantization config; it never leaks across mixtures)
    activation_clip: Optional[float] = None


@dataclass(frozen=True)
class JointSpec:
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    rms_norm_eps: float = 1e-6
    use_flash_attn: bool = False  # prefill attention through the CUDA kernel
    mixtures: Dict[str, MixtureSpec] = field(default_factory=dict)

    @staticmethod
    def from_config(cfg: dict) -> "JointSpec":
        """Reads the keys ``blurr_tpu``'s ``JointSpec.from_config`` reads."""
        mixtures = {}
        for name, m in cfg["mixture"].items():
            if m.get("adaptive_mode"):
                raise NotImplementedError(
                    f"mixture {name!r}: adaptive_mode {m['adaptive_mode']!r} "
                    "(adaLN) is not ported yet"
                )
            clip = m.get("activation_clip")
            mixtures[name] = MixtureSpec(
                hidden_size=m["hidden_size"],
                intermediate_size=m["intermediate_size"],
                rope_theta=float(m.get("rope_theta", 10000.0)),
                use_final_norm=bool(m.get("use_final_norm", False)),
                activation_clip=float(clip) if clip is not None else None,
            )
        return JointSpec(
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg["num_key_value_heads"],
            head_dim=cfg["head_dim"],
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            use_flash_attn=bool(cfg.get("use_flash_attn", False)),
            mixtures=mixtures,
        )


class MixtureLayer(nn.Module):
    """One Gemma decoder layer of one mixture (norm scales are Gemma's ``w``
    of ``(1 + w)``)."""

    def __init__(self, m: MixtureSpec, joint: JointSpec, *, device, dtype):
        super().__init__()
        h, inter = m.hidden_size, m.intermediate_size
        nh, kvh, hd = (
            joint.num_attention_heads, joint.num_key_value_heads, joint.head_dim
        )
        kw = dict(bias=False, device=device, dtype=dtype)
        self.input_norm = nn.Parameter(torch.zeros(h, device=device, dtype=dtype))
        self.q_proj = nn.Linear(h, nh * hd, **kw)
        self.k_proj = nn.Linear(h, kvh * hd, **kw)
        self.v_proj = nn.Linear(h, kvh * hd, **kw)
        self.o_proj = nn.Linear(nh * hd, h, **kw)
        self.post_norm = nn.Parameter(torch.zeros(h, device=device, dtype=dtype))
        self.gate_proj = nn.Linear(h, inter, **kw)
        self.up_proj = nn.Linear(h, inter, **kw)
        self.down_proj = nn.Linear(inter, h, **kw)

    def qkv(self, h, cos, sin, joint: JointSpec, clip: Optional[float] = None):
        """Norm, project and rope: q [B,NH,S,D], k [B,KVH,S,D] (roped), v."""
        nh, kvh, hd = (
            joint.num_attention_heads, joint.num_key_value_heads, joint.head_dim
        )
        x = rms_norm(h, self.input_norm, joint.rms_norm_eps)
        q = apply_rope(split_heads(linear(self.q_proj, x, clip), nh, hd), cos, sin)
        k = apply_rope(split_heads(linear(self.k_proj, x, clip), kvh, hd), cos, sin)
        v = split_heads(linear(self.v_proj, x, clip), kvh, hd)
        return q, k, v

    def finish(self, h, attn, eps: float, clip: Optional[float] = None):
        """Output projection + residual, then the GeGLU MLP + residual;
        ``attn`` is this mixture's slice of the merged attention output."""
        h = h + linear(self.o_proj, attn, clip)
        x = rms_norm(h, self.post_norm, eps)
        inner = geglu(linear(self.gate_proj, x, clip), linear(self.up_proj, x, clip))
        return h + linear(self.down_proj, inner, clip)


class Mixture(nn.Module):
    """One mixture's layers and its optional final norm."""

    def __init__(self, m: MixtureSpec, joint: JointSpec, *, device, dtype):
        super().__init__()
        self.spec = m
        self.layers = nn.ModuleList(
            MixtureLayer(m, joint, device=device, dtype=dtype)
            for _ in range(joint.num_hidden_layers)
        )
        self.final_norm = (
            nn.Parameter(torch.zeros(m.hidden_size, device=device, dtype=dtype))
            if m.use_final_norm else None
        )


def _attention(spec: JointSpec, q, k, v, mask):
    """The JAX dispatch with "TPU" read as "CUDA": with ``use_flash_attn``
    and at least 64 query rows, attention goes to ``flash_attention``, whose
    wrapper launches the CUDA kernel for CUDA tensors (its plain version for
    CPU tensors); otherwise to ``grouped_attention``."""
    if spec.use_flash_attn and q.shape[2] >= FLASH_MIN_QUERIES:
        return flash_attention(q, k, v, mask, softclamp=DEFAULT_SOFTCLAMP)
    return grouped_attention(q, k, v, mask, DEFAULT_SOFTCLAMP)


def _clip_for(spec: JointSpec, name: str) -> Optional[float]:
    """The activation clip of mixture ``name``."""
    return spec.mixtures[name].activation_clip


def scale_embeds(x: torch.Tensor) -> torch.Tensor:
    """sqrt(hidden) entry scaling with the scalar rounded in ``x.dtype``
    (bf16 sqrt(2048) is 45.25)."""
    scale = torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x * scale


def prefill(
    mixtures: Dict[str, Mixture],  # {"vlm": ..., "proprio": ...}
    spec: JointSpec,
    embeds: Dict[str, torch.Tensor],  # {"vlm": [B,Sv,Hv], "proprio": [B,Sp,Hp]}
    position_ids: Dict[str, torch.Tensor],
    prefix_mask: torch.Tensor,  # bool [B, Sv+Sp, Sv+Sp]
) -> KVCache:
    """Run the instruction prefix (image + text + proprio) once per control
    step; returns the per-layer (k, v) cache [B, KVH, Sv+Sp, D]."""
    names = list(embeds)
    eps = spec.rms_norm_eps
    lens = [embeds[n].shape[1] for n in names]
    hs = {n: scale_embeds(embeds[n]) for n in names}
    ropes = {
        n: rope_cos_sin(position_ids[n], spec.head_dim, spec.mixtures[n].rope_theta)
        for n in names
    }
    cache: KVCache = []
    for i in range(spec.num_hidden_layers):
        layers = {n: mixtures[n].layers[i] for n in names}
        parts = [
            layers[n].qkv(hs[n], *ropes[n], spec, _clip_for(spec, n)) for n in names
        ]
        q, k, v = (torch.cat(t, dim=2) for t in zip(*parts))
        cache.append((k, v))
        if i == spec.num_hidden_layers - 1:
            break  # the last layer's attention + MLP output is never read
        attn = merge_heads(_attention(spec, q, k, v, prefix_mask))
        offset = 0
        for n, s in zip(names, lens):
            hs[n] = layers[n].finish(
                hs[n], attn[:, offset : offset + s], eps, _clip_for(spec, n)
            )
            offset += s
    return cache


def decode(
    action: Mixture,
    spec: JointSpec,
    action_embeds: torch.Tensor,  # [B, A, Ha]
    action_position_ids: torch.Tensor,
    cache: KVCache,
    action_mask: torch.Tensor,  # bool [B, A, P+A]
    kv_dequant_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One flow step of the action expert over the cached prefix: the K/V of
    each layer is the cache concatenated with the fresh action K/V. An int8
    cache entry (``Int8KV``) is dequantized to ``kv_dequant_dtype`` (else the action
    dtype) in its layer; the concatenation promotes, as ``jnp.concatenate``
    does (bf16 cache + fp32 fresh K/V -> fp32). Returns the final-normed
    action hidden states."""
    eps = spec.rms_norm_eps
    clip = _clip_for(spec, "action")
    dtype = kv_dequant_dtype or action_embeds.dtype
    cos, sin = rope_cos_sin(
        action_position_ids, spec.head_dim, action.spec.rope_theta
    )
    h = scale_embeds(action_embeds)
    for layer, entry in zip(action.layers, cache):
        if isinstance(entry, Int8KV):
            kc = dequantize_kv(entry.k, entry.k_scale, dtype)
            vc = dequantize_kv(entry.v, entry.v_scale, dtype)
        else:
            kc, vc = entry
        q, k, v = layer.qkv(h, cos, sin, spec, clip)
        k_full = torch.cat([kc, k], dim=2)
        v_full = torch.cat([vc, v], dim=2)
        attn = _attention(spec, q, k_full, v_full, action_mask)
        h = layer.finish(h, merge_heads(attn), eps, clip)
    return rms_norm(h, action.final_norm, eps)
