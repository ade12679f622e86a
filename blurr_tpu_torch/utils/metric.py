"""The action-accuracy metric.

The port's own copy of ``blurr_tpu/utils/metric.py``, on tensors (numpy
arrays are taken too).
"""

from typing import Sequence

import torch


def get_action_accuracy(gt, pred, thresholds: Sequence[float] = (0.1, 0.2)) -> torch.Tensor:
    """The share of (batch, horizon) steps of ``gt`` / ``pred`` [B, H, D]
    whose EVERY action dimension is within each threshold: fp32
    [len(thresholds)]."""
    gt, pred = torch.as_tensor(gt), torch.as_tensor(pred)
    diff = (gt - pred).abs().reshape(-1, gt.shape[-1])
    accs = [((diff < t).float().mean(dim=1) >= 1.0).float().mean() for t in thresholds]
    return torch.stack(accs)
