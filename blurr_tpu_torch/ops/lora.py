"""LoRA adapters for fine-tuning: the adapter module, its injection, its
merge and its trainable mask.

Counterpart of the training half of ``blurr_tpu/ops/lora.py``
(``init_lora_params``, ``is_lora_dict``, ``inject_lora_tree``,
``merge_lora_tree``, ``lora_trainable_mask``; its one-weight helpers
``apply_lora`` and ``merge_lora`` are ``mm`` of a LoRA dict and
``merge_lora_tree`` here; both forms share ``ops.quant.lora_delta``). JAX
turns a target weight leaf into a dict ``{"w", "lora_a", "lora_b",
"lora_s"}`` that ``ops.quant.mm`` dispatches; here the target linear module
is wrapped in a ``LoRALinear`` holding the same tensors under the same names
and layouts (``lora_a`` [in, r], ``lora_b`` [r, out], ``lora_s`` an fp32
scalar), so a JAX adapter tree copies over byte for byte
(``models/pi0/checkpoint.py:load_jax_params``). The base may be an
``nn.Linear`` or any quantized linear of ``ops/quant.py`` (QLoRA: the frozen
base runs int8 or int4 with straight-through gradients, and only the
factors train). ``ops.quant.mm`` also dispatches the dict form.

The PEFT half (``merge_peft_adapter_into_llama``, ``save_peft_adapter``)
belongs to the OpenVLA trainer and is not ported yet (ROADMAP M13).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from blurr_tpu_torch.ops.quant import linear, lora_delta

# JAX's weight keys, by the attribute of the port's module that holds them:
# the mixture linears and the SigLIP layer linears
TARGET_ATTRS = {
    "q_w": "q_proj", "k_w": "k_proj", "v_w": "v_proj", "o_w": "o_proj",
    "gate_w": "gate_proj", "up_w": "up_proj", "down_w": "down_proj",
    "out_w": "out_proj", "fc1_w": "fc1", "fc2_w": "fc2",
}


def init_lora_params(generator: torch.Generator, in_dim: int, out_dim: int, r: int,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A ~ N(0, 1/r) [in, r], B = 0 [r, out] on the generator's device: the
    adapter starts as the identity."""
    device = generator.device
    return {
        "a": torch.randn(in_dim, r, generator=generator, device=device, dtype=dtype)
        * (r**-0.5),
        "b": torch.zeros(r, out_dim, device=device, dtype=dtype),
    }


def is_lora_dict(x) -> bool:
    return isinstance(x, dict) and "lora_a" in x


class LoRALinear(nn.Module):
    """y = base(x) + s * (x @ A) @ B. ``base`` is frozen (an ``nn.Linear``
    or a quantized linear); ``lora_a`` [in, r] and ``lora_b`` [r, out] are
    the parameters that train; ``lora_s`` is a frozen fp32 scalar buffer.
    The mixture's activation clip goes to a quantized base only, never to
    the adapter branch (JAX ``mm``). An ``nn.Linear`` base adds its bias
    after the adapter, as JAX adds a separate bias leaf after ``mm``."""

    def __init__(self, base: nn.Module, lora_a: torch.Tensor, lora_b: torch.Tensor,
                 lora_s: torch.Tensor):
        super().__init__()
        self.base = base
        self.lora_a = nn.Parameter(lora_a)
        self.lora_b = nn.Parameter(lora_b)
        self.register_buffer("lora_s", lora_s.detach().to(torch.float32, copy=True))
        self.in_features, self.rank = lora_a.shape
        self.out_features = lora_b.shape[1]

    @property
    def bias(self):
        return getattr(self.base, "bias", None)

    def forward(self, x, activation_clip: Optional[float] = None):
        if type(self.base) is nn.Linear:
            y = F.linear(x, self.base.weight)
        else:
            y = linear(self.base, x, activation_clip)
        y = y + lora_delta(x, self.lora_a, self.lora_b, self.lora_s)
        if type(self.base) is nn.Linear and self.base.bias is not None:
            y = y + self.base.bias
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"rank={self.rank}, scale={float(self.lora_s):g}")


def _dims(mod: nn.Module) -> Optional[Tuple[int, int]]:
    """(in, out) of a linear module that can take an adapter; None for an
    adapter already there and for any other module."""
    if isinstance(mod, LoRALinear):
        return None
    if hasattr(mod, "in_features") and hasattr(mod, "out_features"):
        return mod.in_features, mod.out_features
    return None


def inject_lora_tree(root: nn.Module, generator: torch.Generator, rank: int,
                     targets: Tuple[str, ...] = ("q_w", "v_w"),
                     alpha: Optional[float] = None, dtype=None) -> int:
    """Wrap every linear of ``root`` (and its submodules) whose JAX key is in
    ``targets`` in a ``LoRALinear``, in place: A ~ N(0, 1/r) drawn from
    ``generator`` (module order), B = 0, s = alpha/r (alpha defaults to r).
    The keys are JAX's (``q_w`` ... ``down_w`` of the mixtures, ``q_w``,
    ``k_w``, ``v_w``, ``out_w``, ``fc1_w``, ``fc2_w`` of SigLIP's layers;
    ``TARGET_ATTRS``); an existing adapter is not wrapped again. The
    factors take ``dtype``, else the base weight's dtype, or fp32 over a
    quantized base (JAX's rule). Returns the number of adapters made."""
    attrs = {TARGET_ATTRS[t] for t in targets if t in TARGET_ATTRS}
    scale = torch.tensor(float(alpha if alpha is not None else rank) / float(rank))
    made = 0
    for mod in list(root.modules()):
        if isinstance(mod, LoRALinear):
            continue
        for attr in sorted(attrs):
            base = getattr(mod, attr, None) if attr in mod._modules else None
            dims = _dims(base) if base is not None else None
            if dims is None:
                continue
            din, dout = dims
            dt = dtype
            if dt is None:
                dt = base.weight.dtype if type(base) is nn.Linear else torch.float32
            device = next(itertools.chain(base.parameters(), base.buffers())).device
            init = init_lora_params(generator, din, dout, rank, torch.float32)
            setattr(mod, attr, LoRALinear(base, init["a"].to(device, dt),
                                          init["b"].to(device, dt), scale.to(device)))
            made += 1
    return made


@torch.no_grad()
def merge_lora_tree(root: nn.Module) -> int:
    """Fold every adapter of ``root`` back into its ``nn.Linear`` base
    (W + s * A @ B, in the base's dtype) and put the base in its place, in
    place. A quantized base cannot absorb the fp delta: raises ValueError,
    as JAX does (serve the adapter modules directly). Returns the number
    merged."""
    merged = 0
    for mod in list(root.modules()):
        for name, child in list(mod._modules.items()):
            if not isinstance(child, LoRALinear):
                continue
            base = child.base
            if type(base) is not nn.Linear:
                raise ValueError(
                    "merge_lora_tree: quantized base weights cannot absorb "
                    "the LoRA delta without a dequant/requant round-trip; "
                    "serve the adapter dict directly (mm dispatches it)."
                )
            delta = child.lora_a @ child.lora_b  # [in, out]
            w = base.weight
            merged_w = (w.T + delta * child.lora_s.to(delta.dtype)).to(w.dtype)
            w.copy_(merged_w.T)
            setattr(mod, name, base)
            merged += 1
    return merged


def lora_trainable_mask(root: nn.Module) -> Dict[str, bool]:
    """{parameter name: trainable} over ``root.named_parameters()``: True
    only on the adapters' ``lora_a`` / ``lora_b`` (the base weights and the
    scales stay frozen). Apply with ``models/pi0/trainable.apply_mask``."""
    return {
        name: name.endswith((".lora_a", ".lora_b"))
        for name, _ in root.named_parameters()
    }
