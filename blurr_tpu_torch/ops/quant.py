"""Quantized linears of the int8, cached-fp, w8a8 and w4a8 tiers, and the
int8 KV cache.

Counterpart of ``blurr_tpu/ops/quant.py``: the quantizers
(``quantize_weight_int8`` with its cached-fp branch, ``quantize_weight_w8a8``,
``quantize_weight_w4a8`` with the MSE clip search, ``quantize_kv_int8`` /
``dequantize_kv``), the matmuls (``w8a8_mm``, ``w4a8_mm`` and the
dispatching ``mm``) and the per-mixture, per-layer and per-tower
quantizers. Weights keep the JAX package's layouts and names:
``{"q": int8 [K, N], "s": fp32 [N]}`` for int8 weight-only, ``{"fp": bf16
[K, N]}`` for cached-fp, ``{"q8a": int8 [K, N], "s": fp32 [N]}`` for w8a8 and
``{"q4": int8 [NB, K//2, BN] block-major packed int4, "s": fp32 [G, N]}`` for
w4a8, so a quantized JAX tree copies over byte for byte. ``repack_w4a8`` /
``repack_w4a8_tree`` re-lay the w4a8 packing for tensor parallelism, as
JAX's do.

In torch idiom a quantized weight is a module: ``Int8Linear``,
``CachedFpLinear``, ``W8A8Linear`` and ``W4A8Linear`` hold those tensors as
buffers (the scale apart from the int8 bytes), and ``from_linear``
quantizes an ``nn.Linear``. The quantizers swap a model's linears for them
in place, one layer at a time, so the fp weight of a layer is released as
soon as its quantized module replaces it; they skip any module that is not
an ``nn.Linear`` (a quantized one, or an ``ops/lora.py:LoRALinear``, as
JAX's skip dicts).

The w8a8 and w4a8 products differentiate as JAX's ``_int8_dot_ste`` and
``_int4_dot_ste`` do (QLoRA training through a frozen quantized base): two
``torch.autograd.Function``s whose forward is the inference product and
whose backward is straight through, ``grad_x = g @ deq(W)^T`` in fp32, the
dequantized weight made only in the backward, and no gradient for the int
payload or the scales. The activation clip stays outside them, so autograd
zeroes the gradient past it as ``jnp.clip`` does.

The int8 weight-only product is the int8 kernel ``int8_matmul``, as the JAX
package's ``int8_mm_nd`` (its ``mm`` dequantizes in XLA instead: the
deliberate difference is in ROADMAP Queue 3). The cached-fp product is a
plain matmul of the bf16 copy. Activations of w8a8 and w4a8 are quantized
per token in plain PyTorch: absmax over the last axis, ``round`` (half to
even, as ``jnp.round``), clamp to int8. The w8a8 product is
``torch._int_mm`` (JAX leaves it to an XLA int8 dot, with no Pallas
kernel); the w4a8 product is the int4 kernel ``int4_matmul``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.ops.int8_matmul import int8_mm_nd
from blurr_tpu_torch.ops.int4_matmul import (
    from_block_major,
    int4_matmul,
    pack_int4,
    pick_block_layout,
    pick_group_size,
    to_block_major,
    unpack_int4_reference,
)

# the mixture linears, by their JAX names, and the port's attribute names
_QUANT_WEIGHT_KEYS = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
    "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj",
}
# the SigLIP layer linears (the patch embedding and the norms stay fp)
_VIT_WEIGHT_KEYS = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "out_w": "out_proj",
    "fc1_w": "fc1", "fc2_w": "fc2",
}
_W4A8_CLIP_GRID = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7)
# the rows a short int8 product is padded to on CUDA (see int8_dot)
INT_MM_PAD_ROWS = 32


def _clip(x: torch.Tensor, activation_clip: Optional[float]) -> torch.Tensor:
    return x if activation_clip is None else x.clamp(-activation_clip, activation_clip)


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as a true fp32 division. A Python scalar divisor would be
    turned into a multiply by its reciprocal on CUDA, which rounds
    differently from JAX's ``a / c``."""
    return a / a.new_full((), c)


# ---------------------------------------------------------------------------
# Quantizers
# ---------------------------------------------------------------------------


def quantize_weight_int8(w: torch.Tensor,
                         cache_fp_dtype: Optional[torch.dtype] = None) -> dict:
    """[..., in, out] -> {"q": int8, "s": fp32 [..., out]}: per-out-channel
    symmetric int8, both contiguous. With ``cache_fp_dtype`` it returns
    {"fp": (q * s) in that dtype} instead: the dequantized copy, with the
    quantization noise and none of the saving."""
    wf = w.float()
    scale = _div(wf.abs().amax(dim=-2).clamp_min(1e-6), 127.0)
    q = torch.round(wf / scale[..., None, :]).clamp(-128, 127).to(torch.int8)
    if cache_fp_dtype is not None:
        return {"fp": (q.float() * scale[..., None, :]).to(cache_fp_dtype).contiguous()}
    return {"q": q.contiguous(), "s": scale.contiguous()}


def quantize_weight_w8a8(w: torch.Tensor) -> dict:
    """[..., in, out] -> {"q8a": int8, "s": fp32 [..., out]}."""
    out = quantize_weight_int8(w)
    return {"q8a": out["q"], "s": out["s"]}


def quantize_weight_w4a8(w: torch.Tensor, group_size: int = 512,
                         mse_scale: bool = True) -> dict:
    """[K, N] -> {"q4": block-major packed int8 [NB, K//2, BN],
    "s": fp32 [G, N]}: group-wise symmetric int4 with one scale per
    (group of K/G rows, out channel).

    ``mse_scale`` searches ``_W4A8_CLIP_GRID`` for each cell and keeps the
    clip whose reconstruction error is least (a later clip wins only when it
    is strictly better). N is zero-padded to NB*BN in ``q4``; ``s`` keeps the
    exact N. JAX's ``shards`` packing for tensor parallelism is this
    packing re-laid by ``repack_w4a8``."""
    if w.dim() != 2 or w.shape[0] % 2:
        raise ValueError(f"w4a8 takes a 2-D weight with an even K, got {tuple(w.shape)}")
    k, n = w.shape
    g = pick_group_size(k, group_size)
    wf = w.float().reshape(k // g, g, n)
    amax = wf.abs().amax(dim=1).clamp_min(1e-6)  # [G, N]
    scale = _div(amax, 7.0)
    q = torch.round(wf / scale[:, None, :]).clamp(-8, 7)
    if mse_scale:
        best = ((q * scale[:, None, :] - wf) ** 2).sum(dim=1)
        for c in _W4A8_CLIP_GRID[1:]:
            s_c = amax * (c / 7.0)
            q_c = torch.round(wf / s_c[:, None, :]).clamp(-8, 7)
            e_c = ((q_c * s_c[:, None, :] - wf) ** 2).sum(dim=1)
            take = e_c < best
            best = torch.where(take, e_c, best)
            scale = torch.where(take, s_c, scale)
            q = torch.where(take[:, None, :], q_c, q)
    q = q.reshape(k, n).to(torch.int8)
    bn, n_pad = pick_block_layout(n)
    if n_pad != n:
        q = F.pad(q, (0, n_pad - n))
    return {"q4": to_block_major(pack_int4(q), bn), "s": scale.contiguous()}


def repack_w4a8(w: dict, shards: int) -> dict:
    """Re-lay a ``{"q4", "s"}`` w4a8 weight for ``shards``-way tensor
    parallelism, losslessly: the packed bytes are re-padded and re-blocked
    so that the block axis NB divides ``shards`` (``pick_block_layout(n,
    shards)``) and each shard owns whole contiguous column blocks. The
    nibbles pack along K, so no byte is split; the group scales carry over
    as they are. Leading [L, ...] axes are kept; a layout that already
    divides comes back as the same dict."""
    q4, s = w["q4"], w["s"]
    n = s.shape[-1]
    nb, bn = q4.shape[-3], q4.shape[-1]
    bn2, n_pad2 = pick_block_layout(n, shards)
    if bn2 == bn and n_pad2 == nb * bn:
        return w
    flat = from_block_major(q4)[..., :n]  # the old layout's padding dropped
    if n_pad2 != n:
        flat = F.pad(flat, (0, n_pad2 - n))
    return {**w, "q4": to_block_major(flat, bn2)}


@torch.no_grad()
def repack_w4a8_tree(root: nn.Module, shards: int) -> nn.Module:
    """``repack_w4a8`` over every ``W4A8Linear`` of ``root``, in place: the
    module keeps its identity and takes the new ``q4`` buffer, so a module
    reached from two places (a tie) is re-laid once and stays shared. A
    layout that already divides keeps its bytes."""
    if shards <= 1:
        return root
    for mod in root.modules():  # each module once, ties included
        if isinstance(mod, W4A8Linear):
            out = repack_w4a8({"q4": mod.q4, "s": mod.s}, shards)
            if out["q4"] is not mod.q4:
                mod.q4 = out["q4"]
    return root


def quantize_kv_int8(kv: torch.Tensor, clip: Optional[float] = None):
    """[..., S, D] -> (int8 values, fp32 scale [..., 1, 1]): one symmetric
    scale per leading index (per batch and head of a [B, H, S, D] cache),
    the absmax over (S, D) taken after the clip."""
    x = _clip(kv.float(), clip)
    scale = _div(x.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-6), 127.0)
    q = torch.round(x / scale).clamp(-128, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _w4a8_deq(q4: torch.Tensor, s: torch.Tensor, k: int) -> torch.Tensor:
    """fp32 [K, N] weight from the block-major packed int4 + group scales."""
    groups, n = s.shape
    wq = unpack_int4_reference(from_block_major(q4))[:, :n]
    return wq.float() * s.repeat_interleave(k // groups, dim=0)


# ---------------------------------------------------------------------------
# Matmuls
# ---------------------------------------------------------------------------


def _quantize_activations(x: torch.Tensor, activation_clip: Optional[float]):
    """x [..., K] -> per-token int8 rows [M, K] (contiguous, M the product
    of the leading axes) and their fp32 scales [..., 1], after the clip."""
    xf = _clip(x.float(), activation_clip)
    xs = _div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6), 127.0)
    xq = torch.round(xf / xs).clamp(-128, 127).to(torch.int8)
    return xq.reshape(-1, x.shape[-1]).contiguous(), xs


def int8_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> exact int32 [M, N]. On CUDA the rows are
    zero-padded to 32 when M <= 16: cuBLASLt's int8 product takes M > 16."""
    m = xq.shape[0]
    if xq.is_cuda and m <= 16:
        padded = F.pad(xq, (0, 0, 0, INT_MM_PAD_ROWS - m))
        return torch._int_mm(padded, q)[:m]
    return torch._int_mm(xq, q)


class _Int8DotSTE(torch.autograd.Function):
    """JAX ``_int8_dot_ste``: fp32 x [..., K] -> fp32 (x_q @ q) * x_scale * s
    through ``torch._int_mm``; backward g @ (q * s)^T in fp32."""

    @staticmethod
    def forward(ctx, xf, q, s):
        ctx.save_for_backward(q, s)
        xq, xs = _quantize_activations(xf, None)
        acc = int8_dot(xq, q).reshape(*xf.shape[:-1], q.shape[1])
        return acc.float() * xs * s

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        return g @ (q.float() * s).T, None, None


class _Int4DotSTE(torch.autograd.Function):
    """JAX ``_int4_dot_ste``: fp32 x [..., K] -> fp32 sum_g (x_q_g @
    unpack(q4)_g) * s_g * x_scale through ``int4_matmul`` (its kernel on
    CUDA, its plain version on the CPU); backward g @ _w4a8_deq(q4, s)^T in
    fp32, a plain matmul as JAX computes it in XLA."""

    @staticmethod
    def forward(ctx, xf, q4, s):
        ctx.save_for_backward(q4, s)
        xq, xs = _quantize_activations(xf, None)
        n = s.shape[1]
        n_pad = q4.shape[0] * q4.shape[2]
        s_pad = s if n_pad == n else F.pad(s, (0, n_pad - n))
        y = int4_matmul(xq, q4, s_pad)[:, :n] * xs.reshape(-1, 1)
        return y.reshape(*xf.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        q4, s = ctx.saved_tensors
        return g @ _w4a8_deq(q4, s, 2 * q4.shape[1]).T, None, None


def w8a8_mm(x: torch.Tensor, w: dict,
            activation_clip: Optional[float] = None) -> torch.Tensor:
    """y = (x_q @ w_q) * x_scale * w_scale, with x quantized per token.
    x [..., K]; w["q8a"] int8 [K, N], w["s"] fp32 [N]; y in x.dtype.
    Differentiable in x through the straight-through ``_Int8DotSTE``."""
    xf = _clip(x.float(), activation_clip)
    return _Int8DotSTE.apply(xf, w["q8a"], w["s"]).to(x.dtype)


def w4a8_mm(x: torch.Tensor, w: dict,
            activation_clip: Optional[float] = None) -> torch.Tensor:
    """y = sum_g (x_q_g @ unpack(w_q4)_g) * s_g * x_scale through
    ``int4_matmul``. x [..., K]; w["q4"] [NB, K//2, BN]; w["s"] [G, N]
    (exact width: the scale is padded to NB*BN here and the output sliced
    back); y in x.dtype. Differentiable in x through the straight-through
    ``_Int4DotSTE``."""
    xf = _clip(x.float(), activation_clip)
    return _Int4DotSTE.apply(xf, w["q4"], w["s"]).to(x.dtype)


def int8_mm(x: torch.Tensor, w: dict,
            activation_clip: Optional[float] = None) -> torch.Tensor:
    """y = x.dtype((bf16(clip(x)) @ w["q"]) * w["s"]) through ``int8_matmul``.
    x [..., K] fp32 or bf16; w["q"] int8 [K, N]; w["s"] fp32 [N]."""
    return int8_mm_nd(_clip(x, activation_clip), w)


def cached_fp_mm(x: torch.Tensor, w: dict,
                 activation_clip: Optional[float] = None) -> torch.Tensor:
    """y = clip(x) @ w["fp"], the copy cast to x.dtype (a plain matmul, as
    JAX computes it outside Pallas)."""
    return _clip(x, activation_clip) @ w["fp"].to(x.dtype)


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """The adapter branch s * (x @ A) @ B in x.dtype, never clipped: the one
    LoRA product, of ``mm``'s dict form and of ``ops/lora.py:LoRALinear``."""
    d = (x @ a.to(x.dtype)) @ b.to(x.dtype)
    return d * s.to(d.dtype)


def mm(x: torch.Tensor, w, activation_clip: Optional[float] = None) -> torch.Tensor:
    """Matmul dispatching on the weight: a plain [in, out] tensor, int8
    {"q","s"}, cached-fp {"fp"}, w8a8 {"q8a","s"}, w4a8 {"q4","s"}, or a
    LoRA dict {"w","lora_a","lora_b","lora_s"} over any of them (y = mm(x,
    w) + s * (x @ A) @ B). The clip applies to quantized weights only, never
    to the LoRA branch, as in the JAX ``mm``."""
    if isinstance(w, dict):
        if "lora_a" in w:
            return mm(x, w["w"], activation_clip) + lora_delta(
                x, w["lora_a"], w["lora_b"], w["lora_s"])
        if "q8a" in w:
            return w8a8_mm(x, w, activation_clip)
        if "q4" in w:
            return w4a8_mm(x, w, activation_clip)
        if "fp" in w:
            return cached_fp_mm(x, w, activation_clip)
        if w.keys() == {"q", "s"}:
            return int8_mm(x, w, activation_clip)
        raise ValueError(f"unknown weight dict with keys {sorted(w)}")
    return x @ w


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class Int8Linear(nn.Module):
    """A linear layer with int8 weight-only weights: buffers ``q`` int8
    [in, out] (row-major, the layout the kernel reads) and ``s`` fp32 [out],
    and an optional fp bias added after the product."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor,
                 bias: Optional[nn.Parameter] = None):
        super().__init__()
        self.in_features, self.out_features = q.shape
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.bias = bias

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        return cls(**quantize_weight_int8(lin.weight.t()), bias=lin.bias)

    def forward(self, x, activation_clip: Optional[float] = None):
        y = int8_mm(x, {"q": self.q, "s": self.s}, activation_clip)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, bias={self.bias is not None}")


class CachedFpLinear(nn.Module):
    """A linear layer holding the dequantized copy of its int8 weight:
    buffer ``fp`` [in, out] (bf16, as the JAX package caches it whatever the
    model dtype), and an optional fp bias added after the product."""

    def __init__(self, fp: torch.Tensor, bias: Optional[nn.Parameter] = None):
        super().__init__()
        self.in_features, self.out_features = fp.shape
        self.register_buffer("fp", fp)
        self.bias = bias

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "CachedFpLinear":
        return cls(**quantize_weight_int8(lin.weight.t(), torch.bfloat16), bias=lin.bias)

    def forward(self, x, activation_clip: Optional[float] = None):
        y = cached_fp_mm(x, {"fp": self.fp}, activation_clip)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, dtype={self.fp.dtype}, "
                f"bias={self.bias is not None}")


class W8A8Linear(nn.Module):
    """A linear layer with w8a8 weights: buffers ``q8a`` int8 [in, out] and
    ``s`` fp32 [out], and an optional fp bias added after the product.

    ``q8a`` has the JAX shape but is held column-major (its bytes are the
    [out, in] of ``nn.Linear``): cuBLASLt's int8 product takes both layouts,
    and this one ran 3.4x faster at a SigLIP fc1 shape (M 64, K 1152, N 4304)
    on an H100. The re-lay is lossless, and ``copy_`` into it from a
    row-major JAX array keeps it."""

    def __init__(self, q8a: torch.Tensor, s: torch.Tensor,
                 bias: Optional[nn.Parameter] = None):
        super().__init__()
        self.in_features, self.out_features = q8a.shape
        self.register_buffer("q8a", q8a.t().contiguous().t())
        self.register_buffer("s", s)
        self.bias = bias

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear) -> "W8A8Linear":
        return cls(**quantize_weight_w8a8(lin.weight.t()), bias=lin.bias)

    def forward(self, x, activation_clip: Optional[float] = None):
        y = w8a8_mm(x, {"q8a": self.q8a, "s": self.s}, activation_clip)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, bias={self.bias is not None}")


class W4A8Linear(nn.Module):
    """A bias-free linear layer with w4a8 weights: buffers ``q4`` int8
    [NB, in//2, BN] (block-major packed int4) and ``s`` fp32 [G, out]."""

    def __init__(self, q4: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.in_features, self.out_features = 2 * q4.shape[1], s.shape[1]
        self.register_buffer("q4", q4)
        self.register_buffer("s", s)

    @classmethod
    @torch.no_grad()
    def from_linear(cls, lin: nn.Linear, group_size: int = 512) -> "W4A8Linear":
        if lin.bias is not None:
            raise ValueError("W4A8Linear has no bias; the w4a8 tier quantizes "
                             "the bias-free mixture linears")
        return cls(**quantize_weight_w4a8(lin.weight.t(), group_size))

    def forward(self, x, activation_clip: Optional[float] = None):
        return w4a8_mm(x, {"q4": self.q4, "s": self.s}, activation_clip)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, groups={self.s.shape[0]}")


QUANTIZED_LINEARS = (Int8Linear, CachedFpLinear, W8A8Linear, W4A8Linear)


def linear(mod: nn.Module, x: torch.Tensor,
           activation_clip: Optional[float] = None) -> torch.Tensor:
    """Apply a linear module with its mixture's clip: an ``nn.Linear``
    ignores it (as ``mm`` does for plain weights); the quantized modules and
    ``ops/lora.py:LoRALinear`` (which hands it to its base) take it."""
    if isinstance(mod, nn.Linear):
        return mod(x)
    return mod(x, activation_clip)


# ---------------------------------------------------------------------------
# Mixture and tower quantizers (in place, one layer at a time)
# ---------------------------------------------------------------------------


def _swap(layer: nn.Module, attr: str, make) -> None:
    lin = getattr(layer, attr)
    if isinstance(lin, nn.Linear):
        setattr(layer, attr, make(lin))  # the fp weight goes with ``lin``


def quantize_mixture_int8(layers: Iterable[nn.Module], cache_fp_weight: bool = False) -> None:
    """Swap every mixture linear of ``layers`` for an ``Int8Linear``, or for
    a ``CachedFpLinear`` holding a bf16 copy under ``cache_fp_weight``."""
    quantize_dense_int8(layers, tuple(_QUANT_WEIGHT_KEYS.values()), cache_fp_weight)


def quantize_dense_int8(modules: Iterable[nn.Module], attrs: Tuple[str, ...],
                        cache_fp_weight: bool = False) -> None:
    """Swap the linears named ``attrs`` of each of ``modules`` as
    ``quantize_mixture_int8`` does (their biases stay fp)."""
    make = CachedFpLinear.from_linear if cache_fp_weight else Int8Linear.from_linear
    for mod in modules:
        for attr in attrs:
            _swap(mod, attr, make)


def quantize_mixture_w8a8(layers: Iterable[nn.Module]) -> None:
    """Swap every mixture linear of ``layers`` for a ``W8A8Linear``."""
    for layer in layers:
        for attr in _QUANT_WEIGHT_KEYS.values():
            _swap(layer, attr, W8A8Linear.from_linear)


def quantize_mixture_w4a8(layers: Iterable[nn.Module], group_size: int = 512,
                          int8_keys: tuple = ()) -> None:
    """Swap every mixture linear of ``layers`` for a ``W4A8Linear`` with
    ``group_size``-row groups, or for a ``W8A8Linear`` where its JAX name
    (``q_w`` ... ``down_w``) is in ``int8_keys``."""
    for layer in layers:
        for key, attr in _QUANT_WEIGHT_KEYS.items():
            if key in int8_keys:
                _swap(layer, attr, W8A8Linear.from_linear)
            else:
                _swap(layer, attr,
                      lambda lin: W4A8Linear.from_linear(lin, group_size))


def quantize_vit_w8a8(layers: Iterable[nn.Module]) -> None:
    """Swap the six linears of every SigLIP encoder layer for
    ``W8A8Linear``s (the patch embedding and the norms stay fp)."""
    for layer in layers:
        for attr in _VIT_WEIGHT_KEYS.values():
            _swap(layer, attr, W8A8Linear.from_linear)
