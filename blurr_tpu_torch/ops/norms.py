"""Normalization primitives with Gemma numerics.

Counterpart of ``blurr_tpu/ops/norms.py`` (``rms_norm``, ``layer_norm``,
``adaptive_rms_norm``, ``adaptive_layerscale``). The adaptive forms take
their linear weights in ``nn.Linear``'s [out, in] layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: fp32 island, ``(1 + w)`` scaling, downcast at the end."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + weight.float())).to(x.dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Standard LayerNorm (SigLIP tower), computed in float32."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def _cond_rows(cond: torch.Tensor) -> torch.Tensor:
    """[B, Dc] -> [B, 1, Dc], so that one conditioning row scales every token."""
    return cond[:, None, :] if cond.dim() == 2 else cond


def adaptive_rms_norm(
    x: torch.Tensor,
    cond: torch.Tensor,  # [B, Dc] or [B, 1, Dc]
    gamma_w: torch.Tensor,  # [H, Dc]
    gamma_b: torch.Tensor,  # [H]
    beta_w: torch.Tensor,  # [H, Dc]
    eps: float = 1e-6,
) -> torch.Tensor:
    """adaLN: RMS-normalize, then scale by sigmoid(linear(cond)) and shift
    by a bias-free linear of cond. The RMS runs in ``x.dtype`` (no fp32
    island, unlike Gemma's RMSNorm), as in JAX and the reference."""
    out = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    cond = _cond_rows(cond)
    gamma = torch.sigmoid(F.linear(cond, gamma_w, gamma_b))
    return out * gamma + F.linear(cond, beta_w)


def adaptive_layerscale(
    x: torch.Tensor,
    cond: torch.Tensor,
    gamma_w: torch.Tensor,  # [H, Dc]
    gamma_b: Optional[torch.Tensor],  # [H]
) -> torch.Tensor:
    """adaLN-Zero's gate of a residual branch: x * sigmoid(linear(cond))."""
    return x * torch.sigmoid(F.linear(_cond_rows(cond), gamma_w, gamma_b))
