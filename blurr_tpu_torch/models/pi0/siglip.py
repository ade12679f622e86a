"""SigLIP vision tower and PaliGemma projector.

Counterpart of ``blurr_tpu/models/pi0/siglip.py``. The patch embedding is
a stride == kernel convolution written as ``patchify`` plus a linear layer,
with the (pi, pj, c) flattening order of the JAX ``patchify``. The tower is
pre-LN: 27 layers of ``mha_flat`` (16 heads x 72 at full width) and a
gelu-tanh MLP, then a final LayerNorm. Linear weights are stored as
``nn.Linear`` ([out, in]); ``checkpoint.load_jax_params`` transposes the
JAX [in, out] arrays. Under ``vlm_quantization.include_vision`` the six
linears of each encoder layer become ``ops.quant.W8A8Linear``s (the JAX
``quantize_vit_w8a8``), called the same way; the patch embedding and the
norms stay fp.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from blurr_tpu_torch.ops.activations import gelu_tanh
from blurr_tpu_torch.ops.attention import mha_flat
from blurr_tpu_torch.ops.norms import layer_norm


def patchify(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, patch*patch*C], flattened as (pi, pj, c)."""
    b, c, h, w = pixel_values.shape
    nh, nw = h // patch_size, w // patch_size
    x = pixel_values.permute(0, 2, 3, 1)  # NHWC
    x = x.reshape(b, nh, patch_size, nw, patch_size, c)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, nh, nw, p, p, C]
    return x.reshape(b, nh * nw, patch_size * patch_size * c)


class SiglipEncoderLayer(nn.Module):
    """One pre-LN encoder layer: LN -> MHA -> residual, LN -> MLP -> residual."""

    def __init__(self, cfg: Dict, *, device, dtype):
        super().__init__()
        d, inter = cfg["hidden_size"], cfg["intermediate_size"]
        self.num_heads = cfg["num_attention_heads"]
        self.eps = float(cfg.get("layer_norm_eps", 1e-6))
        kw = dict(device=device, dtype=dtype)
        self.layer_norm1 = nn.LayerNorm(d, eps=self.eps, **kw)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)
        self.layer_norm2 = nn.LayerNorm(d, eps=self.eps, **kw)
        self.fc1 = nn.Linear(d, inter, **kw)
        self.fc2 = nn.Linear(inter, d, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, s, d = h.shape
        hd = d // self.num_heads
        x = layer_norm(h, self.layer_norm1.weight, self.layer_norm1.bias, self.eps)
        q = self.q_proj(x).view(b, s, self.num_heads, hd)
        k = self.k_proj(x).view(b, s, self.num_heads, hd)
        v = self.v_proj(x).view(b, s, self.num_heads, hd)
        h = h + self.out_proj(mha_flat(q, k, v))
        x = layer_norm(h, self.layer_norm2.weight, self.layer_norm2.bias, self.eps)
        return h + self.fc2(gelu_tanh(self.fc1(x)))


class SiglipVisionModel(nn.Module):
    """[B, C, H, W] -> [B, N_patches, hidden]."""

    def __init__(self, cfg: Dict, *, device, dtype):
        super().__init__()
        d = cfg["hidden_size"]
        self.patch_size = cfg["patch_size"]
        self.eps = float(cfg.get("layer_norm_eps", 1e-6))
        n_patches = (cfg["image_size"] // self.patch_size) ** 2
        kw = dict(device=device, dtype=dtype)
        self.patch_embedding = nn.Linear(
            self.patch_size * self.patch_size * cfg["num_channels"], d, **kw
        )
        self.position_embedding = nn.Parameter(torch.zeros(n_patches, d, **kw))
        self.layers = nn.ModuleList(
            SiglipEncoderLayer(cfg, device=device, dtype=dtype)
            for _ in range(cfg["num_hidden_layers"])
        )
        self.post_layernorm = nn.LayerNorm(d, eps=self.eps, **kw)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        h = self.patch_embedding(patchify(pixel_values, self.patch_size))
        h = h + self.position_embedding[None]
        for layer in self.layers:
            h = layer(h)
        return layer_norm(
            h, self.post_layernorm.weight, self.post_layernorm.bias, self.eps
        )


def projector(cfg: Dict, *, device, dtype) -> nn.Linear:
    """PaliGemma multi-modal projector: one linear layer, vision hidden ->
    projection_dim (1152 -> 2048 at full width)."""
    vc = cfg["vision_config"]
    return nn.Linear(
        vc["hidden_size"], vc["projection_dim"], device=device, dtype=dtype
    )
