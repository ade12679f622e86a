"""Rotary position embeddings in float32, duplicated-half layout.

Counterpart of ``blurr_tpu/ops/rotary.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_cos_sin(
    position_ids: torch.Tensor,  # [B, S] int
    head_dim: int,
    base: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables [B, S, head_dim], on the device of ``position_ids``."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=position_ids.device)
        / head_dim
    )
    inv_freq = 1.0 / (base**exponent)  # [D/2]
    freqs = position_ids.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)  # [B, S, D]
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, H, S, D] by cos/sin [B, S, D]; fp32 inside, output in
    ``x.dtype``."""
    xf = x.float()
    cos = cos.float()[:, None]
    sin = sin.float()[:, None]
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
