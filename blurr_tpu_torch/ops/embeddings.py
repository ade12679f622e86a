"""Flow-time sinusoidal embedding.

Counterpart of ``blurr_tpu/ops/embeddings.py:sinusoidal_pos_emb``.
"""

import math

import torch


def sinusoidal_pos_emb(
    t: torch.Tensor, dim: int, max_period: float = 10000.0
) -> torch.Tensor:
    """[B] -> [B, dim] (sin half then cos half), computed in float32 with the
    ``half_dim - 1`` denominator and cast to ``t.dtype``."""
    half_dim = dim // 2
    scale = math.log(max_period) / (half_dim - 1)
    freqs = torch.exp(
        torch.arange(half_dim, dtype=torch.float32, device=t.device) * -scale
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(t.dtype)
