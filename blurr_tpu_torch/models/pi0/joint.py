"""Joint mixture transformer: prefill of the prefix, decode of the actions,
the naive step's joint forward, and one mixture alone for text generation.

Counterpart of ``blurr_tpu/models/pi0/joint.py`` (``JointSpec``,
``MixtureSpec``, ``_apply_norm``, ``_apply_scale``, ``_attention``,
``prefill``, ``decode``, ``naive_forward``, ``single_forward``,
``alloc_single_cache`` on one card). The mixtures
(vlm, proprio, action expert) share one attention pattern per layer and
keep their own weights. JAX stacks the layers on a leading [L, ...] axis
and scans them; here each layer is an ``nn.Module`` in an ``nn.ModuleList``
and the walk is a Python loop. The KV cache is a list of per-layer (k, v)
pairs [B, KVH, P, D], with K stored after RoPE; the int8 KV cache holds
(k, v, k_scale, v_scale) per layer instead (``ops/quant.py:quantize_kv_int8``),
dequantized inside each layer of each decode step.

Numerics kept from JAX: embeds scaled by sqrt(hidden) rounded in the
compute dtype, Gemma RMSNorm, fp32 RoPE, the tanh soft clamp 50 (off under
``use_softclamp=False``, the standalone Gemma's attention). The last
prefill layer computes only K/V: its attention and MLP output is never read.
A layer's linears are ``nn.Linear``s or, once a mixture is quantized, the
int8 / cached-fp / w8a8 / w4a8 modules of ``ops/quant.py``; each mixture
clamps the activations of its quantized linears with its own
``activation_clip`` (JAX ``_clip_for``).

The naive forward is ``naive_consts`` (rope tables, conditioning) and
``naive_layers`` over a range of layers, which a pipeline stage runs on
its own layers alone (``parallel/pipeline.py``); under sequence
parallelism (``sp``) the vlm rows are the rank's token slice, whose
queries read every rank's keys and values.

An adaptive mixture (``adaptive_mode`` adaLN or adaLN-Zero) replaces its
Gemma norms with ``AdaptiveRMSNorm``s of the flow-time conditioning
``time_cond`` [B, time_hidden_size]; adaLN-Zero also gates the attention
and MLP branches with ``AdaptiveLayerscale``s. A plain mixture ignores
``time_cond``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from blurr_tpu_torch.ops.activations import geglu
from blurr_tpu_torch.ops.attention import (
    DEFAULT_SOFTCLAMP,
    grouped_attention,
    merge_heads,
    split_heads,
)
from blurr_tpu_torch.ops.flash_attention import flash_attention
from blurr_tpu_torch.ops.norms import adaptive_layerscale, adaptive_rms_norm, rms_norm
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
    adaptive_mode: Optional[str] = None  # None | "adaLN" | "adaLN-Zero"
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
    time_hidden_size: int = 256  # the width of an adaptive norm's conditioning
    use_softclamp: bool = True  # the tanh soft clamp of the attention logits
    use_flash_attn: bool = False  # prefill attention through the CUDA kernel
    mixtures: Dict[str, MixtureSpec] = field(default_factory=dict)

    @property
    def softclamp(self) -> Optional[float]:
        return DEFAULT_SOFTCLAMP if self.use_softclamp else None

    @staticmethod
    def from_config(cfg: dict) -> "JointSpec":
        """Reads the keys ``blurr_tpu``'s ``JointSpec.from_config`` reads."""
        mixtures = {}
        for name, m in cfg["mixture"].items():
            clip = m.get("activation_clip")
            mixtures[name] = MixtureSpec(
                hidden_size=m["hidden_size"],
                intermediate_size=m["intermediate_size"],
                rope_theta=float(m.get("rope_theta", 10000.0)),
                use_final_norm=bool(m.get("use_final_norm", False)),
                adaptive_mode=m.get("adaptive_mode") or None,
                activation_clip=float(clip) if clip is not None else None,
            )
        return JointSpec(
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg["num_key_value_heads"],
            head_dim=cfg["head_dim"],
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-6)),
            time_hidden_size=int(cfg.get("time_hidden_size", 256) or 256),
            use_flash_attn=bool(cfg.get("use_flash_attn", False)),
            mixtures=mixtures,
        )


class AdaptiveRMSNorm(nn.Module):
    """adaLN's norm (JAX ``adaptive_rms_norm``'s parameters): ``to_gamma``
    (with bias, through a sigmoid) scales and ``to_beta`` (no bias) shifts
    the RMS-normalized input, both linears of the conditioning."""

    def __init__(self, cond_dim: int, h: int, *, device, dtype):
        super().__init__()
        self.to_gamma = nn.Linear(cond_dim, h, device=device, dtype=dtype)
        self.to_beta = nn.Linear(cond_dim, h, bias=False, device=device, dtype=dtype)

    def forward(self, x, cond, eps: float):
        return adaptive_rms_norm(
            x, cond, self.to_gamma.weight, self.to_gamma.bias, self.to_beta.weight, eps
        )


class AdaptiveLayerscale(nn.Module):
    """adaLN-Zero's branch gate (JAX ``adaptive_layerscale``): ``gamma`` is
    the linear of the conditioning whose sigmoid scales the branch."""

    def __init__(self, cond_dim: int, h: int, *, device, dtype):
        super().__init__()
        self.gamma = nn.Linear(cond_dim, h, device=device, dtype=dtype)

    def forward(self, x, cond):
        return adaptive_layerscale(x, cond, self.gamma.weight, self.gamma.bias)


def _norm_param(m: MixtureSpec, joint: JointSpec, *, device, dtype):
    """A mixture norm: Gemma's scale ``w`` of ``(1 + w)``, or adaLN's
    ``AdaptiveRMSNorm`` in an adaptive mixture."""
    if m.adaptive_mode:
        return AdaptiveRMSNorm(joint.time_hidden_size, m.hidden_size,
                               device=device, dtype=dtype)
    return nn.Parameter(torch.zeros(m.hidden_size, device=device, dtype=dtype))


def apply_norm(norm, x, time_cond, eps: float):
    """JAX ``_apply_norm``: the adaptive norm of ``time_cond``, or Gemma's."""
    if isinstance(norm, AdaptiveRMSNorm):
        return norm(x, time_cond, eps)
    return rms_norm(x, norm, eps)


class MixtureLayer(nn.Module):
    """One Gemma decoder layer of one mixture; under adaLN-Zero with the
    ``post_scale`` and ``final_scale`` gates of its two branches."""

    def __init__(self, m: MixtureSpec, joint: JointSpec, *, device, dtype):
        super().__init__()
        h, inter = m.hidden_size, m.intermediate_size
        nh, kvh, hd = (
            joint.num_attention_heads, joint.num_key_value_heads, joint.head_dim
        )
        kw = dict(bias=False, device=device, dtype=dtype)
        self.input_norm = _norm_param(m, joint, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, nh * hd, **kw)
        self.k_proj = nn.Linear(h, kvh * hd, **kw)
        self.v_proj = nn.Linear(h, kvh * hd, **kw)
        self.o_proj = nn.Linear(nh * hd, h, **kw)
        self.post_norm = _norm_param(m, joint, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(h, inter, **kw)
        self.up_proj = nn.Linear(h, inter, **kw)
        self.down_proj = nn.Linear(inter, h, **kw)
        self.post_scale = self.final_scale = None
        if m.adaptive_mode == "adaLN-Zero":
            tc = joint.time_hidden_size
            self.post_scale = AdaptiveLayerscale(tc, h, device=device, dtype=dtype)
            self.final_scale = AdaptiveLayerscale(tc, h, device=device, dtype=dtype)

    def qkv(self, h, cos, sin, joint: JointSpec, clip: Optional[float] = None,
            time_cond=None, capture: Optional[dict] = None):
        """Norm, project and rope: q [B,NH,S,D], k [B,KVH,S,D] (roped), v.
        The head counts are read from the projections' widths, not from the
        spec: under tensor parallelism ``q_proj`` gives this rank's NH/tp
        heads (``parallel/tensor_parallel.py``) over the whole KV head.
        A ``capture`` dict receives the projections' input as "attn_in"."""
        hd = joint.head_dim
        x = apply_norm(self.input_norm, h, time_cond, joint.rms_norm_eps)
        if capture is not None:
            capture["attn_in"] = x  # q, k and v share it
        qh, kh = linear(self.q_proj, x, clip), linear(self.k_proj, x, clip)
        q = apply_rope(split_heads(qh, qh.shape[-1] // hd, hd), cos, sin)
        k = apply_rope(split_heads(kh, kh.shape[-1] // hd, hd), cos, sin)
        v = split_heads(linear(self.v_proj, x, clip), kh.shape[-1] // hd, hd)
        return q, k, v

    def finish(self, h, attn, eps: float, clip: Optional[float] = None,
               time_cond=None, capture: Optional[dict] = None):
        """Output projection + residual, then the GeGLU MLP + residual;
        ``attn`` is this mixture's slice of the merged attention output.
        adaLN-Zero gates each branch before its residual add. A ``capture``
        dict receives the inputs of the output projection ("o_in"), of the
        gate and up projections ("mlp_in") and of the down projection
        ("down_in", the MLP's inner activation)."""
        a = linear(self.o_proj, attn, clip)
        if self.post_scale is not None:
            a = self.post_scale(a, time_cond)
        h = h + a
        x = apply_norm(self.post_norm, h, time_cond, eps)
        inner = geglu(linear(self.gate_proj, x, clip), linear(self.up_proj, x, clip))
        if capture is not None:
            capture.update(o_in=attn, mlp_in=x, down_in=inner)
        out = linear(self.down_proj, inner, clip)
        if self.final_scale is not None:
            out = self.final_scale(out, time_cond)
        return h + out


class Mixture(nn.Module):
    """One mixture's layers and its optional (plain or adaptive) final norm."""

    def __init__(self, m: MixtureSpec, joint: JointSpec, *, device, dtype):
        super().__init__()
        self.spec = m
        self.layers = nn.ModuleList(
            MixtureLayer(m, joint, device=device, dtype=dtype)
            for _ in range(joint.num_hidden_layers)
        )
        self.final_norm = (
            _norm_param(m, joint, device=device, dtype=dtype)
            if m.use_final_norm else None
        )


def _attention(spec: JointSpec, q, k, v, mask):
    """The JAX dispatch with "TPU" read as "CUDA": with ``use_flash_attn``
    and at least 64 query rows, attention goes to ``flash_attention``, whose
    wrapper launches the CUDA kernel for CUDA tensors (its plain version for
    CPU tensors); otherwise to ``grouped_attention``. Both clamp the logits
    by ``spec.softclamp`` (None: no clamp). The kernel takes contiguous
    tensors: the joint paths' concatenations are, a single mixture's
    head-split projections are not (a copy of q, at most one of K/V)."""
    if spec.use_flash_attn and q.shape[2] >= FLASH_MIN_QUERIES:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise RuntimeError(
                "joint.config.use_flash_attn is set and gradients are on: the flash "
                "attention kernel has no backward (nor has JAX's Pallas kernel); "
                "train with use_flash_attn false"
            )
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        return flash_attention(q, k, v, mask, softclamp=spec.softclamp)
    return grouped_attention(q, k, v, mask, spec.softclamp)


def _clip_for(spec: JointSpec, name: str) -> Optional[float]:
    """The activation clip of mixture ``name``."""
    return spec.mixtures[name].activation_clip


def scale_embeds(x: torch.Tensor) -> torch.Tensor:
    """sqrt(hidden) entry scaling with the scalar rounded in ``x.dtype``
    (bf16 sqrt(2048) is 45.25)."""
    # a fill on the device: torch.tensor(..., device=) would copy from the
    # host and wait for the stream
    scale = torch.full((), x.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x * scale


def prefill(
    mixtures: Dict[str, Mixture],  # {"vlm": ..., "proprio": ...}
    spec: JointSpec,
    embeds: Dict[str, torch.Tensor],  # {"vlm": [B,Sv,Hv], "proprio": [B,Sp,Hp]}
    position_ids: Dict[str, torch.Tensor],
    prefix_mask: torch.Tensor,  # bool [B, Sv+Sp, Sv+Sp]
    time_cond: Optional[torch.Tensor] = None,
) -> KVCache:
    """Run the instruction prefix (image + text + proprio) once per control
    step; returns the per-layer (k, v) cache [B, KVH, Sv+Sp, D]. An adaptive
    mixture is conditioned on ``time_cond`` (the caller passes t=0's: a
    cached K/V holds for one conditioning only)."""
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
            layers[n].qkv(hs[n], *ropes[n], spec, _clip_for(spec, n), time_cond)
            for n in names
        ]
        q, k, v = (torch.cat(t, dim=2) for t in zip(*parts))
        cache.append((k, v))
        if i == spec.num_hidden_layers - 1:
            break  # the last layer's attention + MLP output is never read
        attn = merge_heads(_attention(spec, q, k, v, prefix_mask))
        offset = 0
        for n, s in zip(names, lens):
            hs[n] = layers[n].finish(
                hs[n], attn[:, offset : offset + s], eps, _clip_for(spec, n), time_cond
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
    time_cond: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One flow step of the action expert over the cached prefix: the K/V of
    each layer is the cache concatenated with the fresh action K/V. An int8
    cache entry (``Int8KV``) is dequantized to ``kv_dequant_dtype`` (else the action
    dtype) in its layer; the concatenation promotes, as ``jnp.concatenate``
    does (bf16 cache + fp32 fresh K/V -> fp32). An adaptive action mixture
    is conditioned on ``time_cond``, this flow step's time embedding.
    Returns the final-normed action hidden states."""
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
        q, k, v = layer.qkv(h, cos, sin, spec, clip, time_cond)
        k_full = torch.cat([kc, k], dim=2)
        v_full = torch.cat([vc, v], dim=2)
        attn = _attention(spec, q, k_full, v_full, action_mask)
        h = layer.finish(h, merge_heads(attn), eps, clip, time_cond)
    return apply_norm(action.final_norm, h, time_cond, eps)


def naive_consts(spec: JointSpec, names: Sequence[str], position_ids: Dict[str, torch.Tensor],
                 time_cond: Optional[torch.Tensor] = None,
                 prefix_time_cond: Optional[torch.Tensor] = None):
    """(ropes, conditioning) of each mixture for ``naive_layers``: the
    RoPE tables of its position ids, and the time conditioning an adaptive
    mixture reads (the action mixture ``time_cond``; the others
    ``prefix_time_cond`` when given, else ``time_cond``)."""
    ropes = {
        n: rope_cos_sin(position_ids[n], spec.head_dim, spec.mixtures[n].rope_theta)
        for n in names
    }
    tcs = {
        n: time_cond if n == "action" or prefix_time_cond is None else prefix_time_cond
        for n in names
    }
    return ropes, tcs


def naive_layers(
    mixtures: Dict[str, Mixture],
    spec: JointSpec,
    hs: Dict[str, torch.Tensor],  # each mixture's hidden states [B, S, H], scaled
    ropes: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
    mask: torch.Tensor,  # bool [B, rows, T]: the rows of hs, in mixture order
    tcs: Dict[str, Optional[torch.Tensor]],
    layers: Sequence[int],
    remat: bool = False,
    capture: bool = False,
    sp=None,
):
    """Layers ``layers`` of the naive forward (``naive_forward``) on the
    hidden states ``hs``; returns (the hidden states after them, each
    layer's captured inputs or None). In the model's last layer only the
    action mixture's output is read, so the others skip their output
    projection and MLP there, unless ``capture``.

    ``sp`` (a mesh with a seq axis): ``hs["vlm"]`` and its rope tables are
    the rank's token rows, and every other mixture's rows are whole on
    every rank. Each layer's queries are the rank's rows over every
    rank's vlm keys and values, gathered together through
    ``gather_sum_from_group`` (the gradient of a rank's K/V is the sum of
    every rank's), and the replicated rows' keys and values; ``mask`` is
    cut to those query rows."""
    names = list(hs)
    eps = spec.rms_norm_eps
    last = spec.num_hidden_layers - 1
    split = sp is not None and sp.seq > 1
    caps = [] if capture else None

    def layer(i, *h):
        hs = dict(zip(names, h))
        lens = [x.shape[1] for x in h]
        mods = {n: mixtures[n].layers[i] for n in names}
        cap = {n: {} for n in names} if capture else dict.fromkeys(names)
        parts = [
            list(mods[n].qkv(hs[n], *ropes[n], spec, _clip_for(spec, n), tcs[n], cap[n]))
            for n in names
        ]
        if split:
            from blurr_tpu_torch.parallel.mesh import gather_sum_from_group

            part = parts[names.index("vlm")]
            kv = gather_sum_from_group(torch.cat(part[1:], dim=1), sp.seq_group, 2)
            part[1:] = kv.chunk(2, dim=1)
        q, k, v = (torch.cat(t, dim=2) for t in zip(*parts))
        attn = merge_heads(_attention(spec, q, k, v, mask))
        offset = 0
        for n, s in zip(names, lens):
            if i < last or n == "action" or capture:
                hs[n] = mods[n].finish(
                    hs[n], attn[:, offset : offset + s], eps, _clip_for(spec, n), tcs[n],
                    cap[n],
                )
            offset += s
        if capture:
            caps.append(cap)
        return tuple(hs[n] for n in names)

    h = tuple(hs[n] for n in names)
    for i in layers:
        h = checkpoint(layer, i, *h, use_reentrant=False) if remat else layer(i, *h)
    return dict(zip(names, h)), caps


def naive_forward(
    mixtures: Dict[str, Mixture],  # {"vlm": ..., "proprio": ..., "action": ...}
    spec: JointSpec,
    embeds: Dict[str, torch.Tensor],  # the three mixtures' [B, S, H]
    position_ids: Dict[str, torch.Tensor],
    full_mask: torch.Tensor,  # bool [B, T, T], T = Sv + Sp + A
    time_cond: Optional[torch.Tensor] = None,
    prefix_time_cond: Optional[torch.Tensor] = None,
    remat: bool = False,
    capture: bool = False,
):
    """One flow step with no cache: every mixture goes through every layer,
    and each layer's attention runs once over all T rows with the full block
    mask (the reference's no_append path). Returns the action mixture's
    final-normed hidden states [B, A, Ha]. ``remat`` wraps each layer in
    ``torch.utils.checkpoint`` (non-reentrant), JAX's ``jax.checkpoint`` of
    the scanned layer: the backward recomputes the layer's activations
    instead of keeping them.

    An adaptive action mixture is conditioned on ``time_cond``; the other
    adaptive mixtures on ``prefix_time_cond`` when given (the reference
    freezes the prefix K/V at the first flow step, so its proprio mixture
    stays conditioned on t=0), else on ``time_cond``. In the last layer only
    the action mixture's output is read, so the others skip their output
    projection and MLP there (JAX computes and discards them).

    ``capture`` (GPTQ calibration, ``models/pi0/calibrate.py``) also returns
    the inputs of every mixture's linears, ``{mixture: {"attn_in" | "o_in" |
    "mlp_in" | "down_in": [L, B, S, K]}}``, as JAX's ``capture``: then every
    mixture runs its whole last layer, since its inputs there are wanted too.
    It does not combine with ``remat``."""
    if capture and remat:
        raise ValueError("capture (GPTQ calibration) does not combine with remat")
    names = list(embeds)
    eps = spec.rms_norm_eps
    hs = {n: scale_embeds(embeds[n]) for n in names}
    ropes, tcs = naive_consts(spec, names, position_ids, time_cond, prefix_time_cond)
    hs, caps = naive_layers(mixtures, spec, hs, ropes, full_mask, tcs,
                            range(spec.num_hidden_layers), remat, capture)
    out = apply_norm(mixtures["action"].final_norm, hs["action"], tcs["action"], eps)
    if capture:
        return out, {n: {key: torch.stack([c[n][key] for c in caps]) for key in caps[0][n]}
                     for n in names}
    return out


# --------------------------------------------------------------------------
# One mixture alone, autoregressive (text generation, append-mode cache)
# --------------------------------------------------------------------------

# (k, v), each [L, B, KVH, max_len, D]
SingleCache = Tuple[torch.Tensor, torch.Tensor]


def single_forward(
    mixture: Mixture,
    spec: JointSpec,
    name: str,
    embeds: torch.Tensor,  # [B, S, H]
    position_ids: torch.Tensor,  # [B, S]
    mask: torch.Tensor,  # bool [B, S, Skv]
    cache: Optional[SingleCache] = None,
    cache_len: int = 0,  # tokens already in the cache
) -> Tuple[torch.Tensor, Optional[SingleCache]]:
    """One forward of mixture ``name`` alone. With ``cache`` (from
    ``alloc_single_cache``) each layer writes the K/V of the S query tokens
    into its buffers at ``cache_len`` and attends over the whole buffer,
    whose unwritten columns ``mask`` must hide; without, the tokens attend
    over themselves (Skv = S). The final norm applies where the mixture has
    one. Returns (hidden [B, S, H], cache).

    Unlike JAX's functional update, the cache is written IN PLACE and the
    same buffers are returned. ``cache_len`` is a host int, so a decode
    step reads nothing back from the device."""
    eps = spec.rms_norm_eps
    clip = _clip_for(spec, name)
    s = embeds.shape[1]
    if cache is not None and cache_len + s > cache[0].shape[3]:
        raise ValueError(f"{s} tokens at offset {cache_len} overflow a cache of "
                         f"{cache[0].shape[3]}")
    cos, sin = rope_cos_sin(position_ids, spec.head_dim, spec.mixtures[name].rope_theta)
    h = scale_embeds(embeds)
    for i, layer in enumerate(mixture.layers):
        q, k, v = layer.qkv(h, cos, sin, spec, clip)
        if cache is not None:
            k_buf, v_buf = cache[0][i], cache[1][i]
            k_buf[:, :, cache_len:cache_len + s] = k
            v_buf[:, :, cache_len:cache_len + s] = v
            k, v = k_buf, v_buf
        attn = _attention(spec, q, k, v, mask)
        h = layer.finish(h, merge_heads(attn), eps, clip)
    if mixture.final_norm is not None:
        h = apply_norm(mixture.final_norm, h, None, eps)
    return h, cache


def alloc_single_cache(spec: JointSpec, batch: int, max_len: int, dtype,
                       device) -> SingleCache:
    """A zeroed (k, v) pair of [L, B, KVH, max_len, D] for ``single_forward``."""
    shape = (spec.num_hidden_layers, batch, spec.num_key_value_heads, max_len,
             spec.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
