"""Pi-0 block-attention masks and position ids, built on the device.

Counterpart of ``blurr_tpu/ops/masks.py`` (``pi0_full_mask``,
``pi0_prefix_mask``, ``pi0_action_mask``, ``pi0_position_ids``). The masks are boolean (True =
may attend) and come from the token-validity vector ``attention_mask``
[B, max_image_text_tokens] on its own device. Pad rows of the prefix mask
are fully masked; the attention's ``finfo.min`` fill keeps them finite.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _counts(attention_mask: torch.Tensor) -> torch.Tensor:
    """Valid image+text tokens per batch element, shaped [B, 1, 1]."""
    return attention_mask.to(torch.int32).sum(dim=1)[:, None, None]


def pi0_full_mask(
    attention_mask: torch.Tensor,
    max_image_text_tokens: int,
    num_proprio_tokens: int,
    num_action_tokens: int,
) -> torch.Tensor:
    """Block mask [B, T, T] over image/text + proprio + action (the naive
    step's joint attention): the prefix mask in the top-left block, and the
    action rows over the valid image/text, proprio and action keys."""
    p_start = max_image_text_tokens
    p_end = p_start + num_proprio_tokens
    total = p_end + num_action_tokens
    cnt = _counts(attention_mask)
    idx = torch.arange(total, device=attention_mask.device)
    r = idx[None, :, None]
    c = idx[None, None, :]
    img_self = (r < cnt) & (c < cnt)
    suffix_to_img = (r >= p_start) & (c < cnt)
    proprio_self = (r >= p_start) & (r < p_end) & (c >= p_start) & (c < p_end)
    action_rows = (r >= p_end) & (c >= p_start)
    return img_self | suffix_to_img | proprio_self | action_rows


def pi0_prefix_mask(
    attention_mask: torch.Tensor,
    max_image_text_tokens: int,
    num_proprio_tokens: int,
) -> torch.Tensor:
    """Prefill mask [B, P, P] over image/text + proprio."""
    p_start = max_image_text_tokens
    p_end = p_start + num_proprio_tokens
    cnt = _counts(attention_mask)
    idx = torch.arange(p_end, device=attention_mask.device)
    r = idx[None, :, None]
    c = idx[None, None, :]
    img_self = (r < cnt) & (c < cnt)
    suffix_to_img = (r >= p_start) & (c < cnt)
    proprio_self = (r >= p_start) & (c >= p_start)
    return img_self | suffix_to_img | proprio_self


def pi0_action_mask(
    attention_mask: torch.Tensor,
    max_image_text_tokens: int,
    num_proprio_tokens: int,
    num_action_tokens: int,
) -> torch.Tensor:
    """Decode mask [B, A, T]: action queries over valid image/text, proprio
    and action keys."""
    p_start = max_image_text_tokens
    total = p_start + num_proprio_tokens + num_action_tokens
    cnt = _counts(attention_mask)
    c = torch.arange(total, device=attention_mask.device)[None, None, :]
    row = (c < cnt) | (c >= p_start)
    return row.expand(attention_mask.shape[0], num_action_tokens, total)


def pi0_position_ids(
    batch_size: int,
    max_image_text_tokens: int,
    num_proprio_tokens: int,
    num_action_tokens: int,
    *,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-mixture RoPE position ids, each starting at 1; the action ids
    continue after proprio since the two share mixture weights."""

    def rep(lo, hi):
        ids = torch.arange(lo, hi, dtype=torch.int32, device=device)[None, :]
        return ids.expand(batch_size, hi - lo)

    vlm = rep(1, max_image_text_tokens + 1)
    proprio = rep(1, num_proprio_tokens + 1)
    action = rep(
        num_proprio_tokens + 1, num_proprio_tokens + num_action_tokens + 1
    )
    return vlm, proprio, action
