"""Trainable-parameter selection for Pi-0 fine-tuning.

Counterpart of ``blurr_tpu/models/pi0/trainable.py``. JAX builds a boolean
mask pytree for ``optax.masked``; here a mask is ``{parameter name:
trainable}`` over ``model.named_parameters()`` and ``apply_mask`` turns it
into ``requires_grad``, so a frozen parameter gets no gradient at all and
the optimizer (``utils/optim.py:AdamW``) holds only the trainable ones. The
proprio mixture IS the action module, so its parameters appear once, under
the action mixture's names (JAX's canonical tied tree, whose proprio is
None, resolved to the action leaves). The scopes are prefixes of the names,
so they resolve on a model ``parallel/mesh.py:shard_params`` has sharded
too (a TP wrapper's ``.local.`` paths keep the module's prefix), where the
proprio mixture is still the action module, so its gradient sums into the
same parameters (JAX's ``test_shard_params_preserves_weight_tying_and_mask``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

# the parameter groups of each scope, by the prefix of their names
_ACTION_EXPERT = ("action_encoder_w1.", "action_encoder_w2.", "action_encoder_w3.",
                  "proprio_encoder.", "action_decoder.", "joint.action.")
_VLM = ("vision_tower.", "multi_modal_projector.", "joint.vlm.")


def _mask(model: nn.Module, prefixes) -> Dict[str, bool]:
    return {name: prefixes is True or name.startswith(tuple(prefixes or ()))
            for name, _ in model.named_parameters()}


def action_expert_mask(model: nn.Module) -> Dict[str, bool]:
    """Trainable = the action mixture (and so the tied proprio mixture), the
    action and proprio encoders and the action decoder."""
    return _mask(model, _ACTION_EXPERT)


def vlm_mask(model: nn.Module) -> Dict[str, bool]:
    """Trainable = the vision tower, the projector and the vlm mixture."""
    return _mask(model, _VLM)


def all_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    return _mask(model, True)


def frozen_mask(model: nn.Module) -> Dict[str, bool]:
    """freeze_all_weights analogue."""
    return _mask(model, ())


SCOPES = {"all": all_trainable_mask, "action_expert": action_expert_mask,
          "vlm": vlm_mask, "frozen": frozen_mask}


def apply_mask(model: nn.Module, mask: Dict[str, bool]) -> List[torch.nn.Parameter]:
    """Set ``requires_grad`` from ``mask`` (every parameter must be named in
    it) and return the trainable parameters in ``named_parameters`` order."""
    params = dict(model.named_parameters())
    if params.keys() != mask.keys():
        raise ValueError("the mask does not name the model's parameters: "
                         f"{sorted(params.keys() ^ mask.keys())[:8]}")
    for name, p in params.items():
        p.requires_grad_(bool(mask[name]))
    return [p for name, p in params.items() if mask[name]]
