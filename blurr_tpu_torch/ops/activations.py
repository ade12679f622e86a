"""Activation functions (tanh-approximated GELU, as in Gemma and SigLIP).

Counterpart of ``blurr_tpu/ops/activations.py``.
"""

import torch
import torch.nn.functional as F


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def geglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Gemma GeGLU combiner: gelu_tanh(gate) * up."""
    return gelu_tanh(gate) * up


__all__ = ["gelu_tanh", "silu", "geglu"]
