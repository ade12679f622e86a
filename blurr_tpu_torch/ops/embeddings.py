"""Flow-time sinusoidal embedding, and token lookups through a table that
may be split over tensor-parallel ranks.

Counterpart of ``blurr_tpu/ops/embeddings.py:sinusoidal_pos_emb``.
``embedding`` and ``table_logits`` take a token table that is a tensor or
a module (``parallel/tensor_parallel.py:VocabParallelEmbedding``, which
holds the rank's rows and joins the ranks).
"""

import math

import torch
from torch import nn
from torch.nn import functional as F


def embedding(ids: torch.Tensor, table) -> torch.Tensor:
    """The rows of ``table`` [V, H] at ``ids``."""
    return table(ids) if isinstance(table, nn.Module) else F.embedding(ids, table)


def table_logits(h: torch.Tensor, table) -> torch.Tensor:
    """``h @ table.T`` in ``h.dtype``: the logits of a head tied to a token
    table."""
    return table.logits(h) if isinstance(table, nn.Module) else h @ table.t().to(h.dtype)


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
