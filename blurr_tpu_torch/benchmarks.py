"""The Pi-0 harness's config and model loaders, shared by the open-loop
evaluator (``scripts/eval_openloop_torch.py``) and the experiments.

Counterpart of ``blurr_tpu/benchmarks.py:load_cfg`` and ``load_model``.
The timing half of that module (``bench``, ``prepare_inputs``,
``first_call_seconds``) belongs to the port's benchmark and is not here.
"""

from __future__ import annotations

import torch

from blurr_tpu_torch.models.pi0.checkpoint import load_checkpoint
from blurr_tpu_torch.models.pi0.pizero import PiZero
from blurr_tpu_torch.presets import load_config

# a YAML config; a relative path that does not exist is taken relative to
# the bundled config tree's parent (``config/eval/bridge.yaml``)
load_cfg = load_config


def load_model(cfg, checkpoint_path: str, dtype: torch.dtype, device="cuda") -> PiZero:
    """A ``PiZero`` on ``device`` in ``dtype``: random weights drawn from a
    generator seeded with 0 for "random" (or "none", ""), else a reference
    ``.pt`` or a ``--save-dir`` parameter tree (``checkpoint.load_checkpoint``);
    then the action and vlm quantization tiers of ``cfg``, in place."""
    model = PiZero(cfg, device=device, dtype=dtype)
    if str(checkpoint_path).lower() in {"random", "none", ""}:
        model.init_params(torch.Generator(device=model.embed_tokens.device).manual_seed(0))
    else:
        load_checkpoint(model, str(checkpoint_path))
    model.enable_action_quantization()
    model.enable_vlm_quantization()
    return model.eval()
