"""Grouped-query attention with the Gemma soft-clamp, in plain PyTorch.

Counterpart of ``blurr_tpu/ops/attention.py`` (``split_heads``,
``merge_heads``, ``grouped_attention``, ``mha_flat``). JAX runs these in
XLA, not Pallas, so they stay plain PyTorch here; the prefill's fused
kernel is ``ops/flash_attention.py``. Numerics kept from JAX:

    logits = fp32(q) @ fp32(k)^T * d^-0.5
    logits = tanh(logits / 50) * 50                (optional soft clamp)
    logits = where(mask, logits, finfo(float32).min)
    out = softmax(logits in fp32).to(q.dtype) @ v

GQA groups the query heads over the KV heads (no ``repeat_kv`` copy of
K/V). A fully masked row gets uniform weights, so it stays finite.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_SOFTCLAMP = 50.0


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """[B, S, n*d] -> [B, n, S, d] (a view)."""
    b, s, _ = x.shape
    return x.view(b, s, n_heads, head_dim).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, n, S, d] -> [B, S, n*d]."""
    b, nh, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, nh * hd)


def grouped_attention(
    q: torch.Tensor,  # [B, NH, Sq, D]
    k: torch.Tensor,  # [B, KVH, Skv, D]
    v: torch.Tensor,  # [B, KVH, Skv, D]
    mask: Optional[torch.Tensor] = None,  # bool [B, Sq, Skv]
    softclamp: Optional[float] = DEFAULT_SOFTCLAMP,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns [B, NH, Sq, D] in ``q.dtype``."""
    b, nh, sq, d = q.shape
    kvh = k.shape[1]
    if nh % kvh:
        raise ValueError(f"{nh} query heads do not group over {kvh} KV heads")
    g = nh // kvh
    if scale is None:
        scale = d**-0.5
    qg = q.reshape(b, kvh, g, sq, d).float()
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if softclamp is not None:
        logits = torch.tanh(logits / softclamp) * softclamp
    if mask is not None:
        big_neg = torch.finfo(torch.float32).min
        logits = logits.masked_fill(~mask[:, None, None], big_neg)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", weights, v)
    return out.reshape(b, nh, sq, d)


def mha_flat(
    q: torch.Tensor,  # [B, S, NH, HD]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unmasked MHA over the [B, S, NH, HD] layout (SigLIP); fp32 logits and
    softmax, no clamp. Returns [B, S, NH*HD]."""
    b, s, nh, hd = q.shape
    if scale is None:
        scale = hd**-0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return out.reshape(b, s, nh * hd)
