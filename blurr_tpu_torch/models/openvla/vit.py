"""The ViT encoder of OpenVLA's vision towers.

Counterpart of ``blurr_tpu/models/openvla/vit.py`` (``ViTSpec``,
``init_vit_params``, ``vit_forward``). It covers both timm towers that
OpenVLA fuses: DINOv2 ViT-L/14 with 4 register tokens and LayerScale, and
SigLIP ViT-So400m/14 (no class token). Prismatic reads the penultimate
block's output (``feature_layer = -2``), so the last block is neither
stored nor run, and the class and register tokens are dropped from the
output.

The position table has one of two layouts, told apart by its row count:
timm's ``no_embed_class`` layout (register models) covers the patches only
and is added before the prefix tokens are put in front; the embed-class
layout covers [cls] + patches and is added after the class token, the
register tokens going in after it. Attention is the plain ``mha_flat``, as
JAX computes it in XLA (no Pallas kernel). The patch embedding is
``patchify`` plus a linear, with the (pi, pj, c) flattening of the Pi-0
tower, which the checkpoint bridge's convolution reshape matches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.models.pi0.siglip import patchify
from blurr_tpu_torch.ops.attention import mha_flat
from blurr_tpu_torch.ops.norms import layer_norm


@dataclass(frozen=True)
class ViTSpec:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    patch_size: int = 14
    image_size: int = 224
    num_channels: int = 3
    cls_token: bool = False
    reg_tokens: int = 0
    layerscale: bool = False
    feature_layer: int = -2  # prismatic: the penultimate block's output
    eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.cls_token else 0) + self.reg_tokens

    @property
    def effective_num_layers(self) -> int:
        """The blocks that run: with ``feature_layer`` -2 the last one never
        does, so it is not stored either."""
        if self.feature_layer < 0:
            return self.num_layers + self.feature_layer + 1
        return self.feature_layer + 1

    @property
    def pos_rows(self) -> int:
        """Rows of the position table a fresh tower gets: patches only for
        register models (no_embed_class), else [cls] + patches."""
        if self.reg_tokens:
            return self.num_patches
        return (1 if self.cls_token else 0) + self.num_patches


class ViTBlock(nn.Module):
    """Pre-LN block: LN -> fused qkv -> MHA -> proj (-> LayerScale) ->
    residual, LN -> fc1 -> exact GELU -> fc2 (-> LayerScale) -> residual."""

    def __init__(self, spec: ViTSpec, *, device, dtype):
        super().__init__()
        d, inter = spec.hidden_size, spec.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.spec = spec
        self.norm1 = nn.LayerNorm(d, eps=spec.eps, **kw)
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.proj = nn.Linear(d, d, **kw)
        self.norm2 = nn.LayerNorm(d, eps=spec.eps, **kw)
        self.fc1 = nn.Linear(d, inter, **kw)
        self.fc2 = nn.Linear(inter, d, **kw)
        if spec.layerscale:
            self.ls1 = nn.Parameter(torch.empty(d, **kw))
            self.ls2 = nn.Parameter(torch.empty(d, **kw))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        s = self.spec
        b, n, d = h.shape
        x = layer_norm(h, self.norm1.weight, self.norm1.bias, s.eps)
        q, k, v = (t.reshape(b, n, s.num_heads, d // s.num_heads)
                   for t in self.qkv(x).chunk(3, dim=-1))
        a = self.proj(mha_flat(q, k, v))
        if s.layerscale:
            a = a * self.ls1
        h = h + a
        x = layer_norm(h, self.norm2.weight, self.norm2.bias, s.eps)
        x = self.fc2(F.gelu(self.fc1(x)))
        if s.layerscale:
            x = x * self.ls2
        return h + x


class ViT(nn.Module):
    """[B, C, H, W] -> patch features [B, num_patches, hidden] of the
    ``feature_layer`` block, the prefix tokens dropped."""

    def __init__(self, spec: ViTSpec, *, device, dtype):
        super().__init__()
        self.spec = s = spec
        d = s.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.patch_embed = nn.Linear(s.patch_size * s.patch_size * s.num_channels, d, **kw)
        self.pos_embed = nn.Parameter(torch.empty(s.pos_rows, d, **kw))
        if s.cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, d, **kw))
        if s.reg_tokens:
            self.reg_tokens = nn.Parameter(torch.empty(1, s.reg_tokens, d, **kw))
        self.blocks = nn.ModuleList(
            ViTBlock(s, device=device, dtype=dtype) for _ in range(s.effective_num_layers)
        )

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """JAX ``init_vit_params``'s distributions: linear weights and the
        position table N(0, 1/fan_in), biases and prefix tokens 0,
        LayerNorm scales 1, LayerScale 1e-5."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features**-0.5, generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, ViTBlock) and mod.spec.layerscale:
                mod.ls1.fill_(1e-5)
                mod.ls2.fill_(1e-5)
        self.pos_embed.normal_(0.0, self.spec.hidden_size**-0.5, generator=generator)
        for name in ("cls_token", "reg_tokens"):
            if hasattr(self, name):
                getattr(self, name).zero_()

    def _prefix(self, name: str, b: int, h: torch.Tensor) -> torch.Tensor:
        t = getattr(self, name)
        return t.expand(b, t.shape[1], t.shape[2]).to(h.dtype)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        s = self.spec
        h = self.patch_embed(patchify(pixel_values, s.patch_size))
        b = h.shape[0]
        pos = self.pos_embed[None].to(h.dtype)
        if self.pos_embed.shape[0] == s.num_patches:
            # no_embed_class: the prefix tokens get no position (timm's
            # DINOv2 converter folds the class row into cls_token); the
            # order is (cls, reg, patches), as timm's _pos_embed
            h = h + pos
            prefix = [self._prefix(n, b, h) for n, on in
                      (("cls_token", s.cls_token), ("reg_tokens", s.reg_tokens)) if on]
            if prefix:
                h = torch.cat(prefix + [h], dim=1)
        else:
            if s.cls_token:
                h = torch.cat([self._prefix("cls_token", b, h), h], dim=1)
            h = h + pos
            if s.reg_tokens:  # after the position table, before the blocks
                reg = self._prefix("reg_tokens", b, h)
                h = (torch.cat([h[:, :1], reg, h[:, 1:]], dim=1) if s.cls_token
                     else torch.cat([reg, h], dim=1))
        for block in self.blocks:
            h = block(h)
        return h[:, s.num_prefix_tokens:]
