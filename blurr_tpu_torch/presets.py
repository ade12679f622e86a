"""Config loading and the named run presets of the Pi-0 CLIs.

The preset table is the port's own copy of
``scripts/eval_pi0_simpler.py:PRESETS`` (a test holds the two equal).
Configs load through the port's own ``config.core.load_yaml``.
"""

from __future__ import annotations

from pathlib import Path

from blurr_tpu_torch.config.core import Config, load_yaml
from blurr_tpu_torch.paths import config_root

# toggles applied on top of the YAML config, keyed by preset name
PRESETS = {
    "baseline": dict(use_prefix_kv_cache=False, use_bf16=False,
                     use_torch_compile=False, num_inference_steps=10),
    "prefix_cache": dict(use_prefix_kv_cache=True, use_bf16=False,
                         use_torch_compile=False, num_inference_steps=10),
    "blurr": dict(use_prefix_kv_cache=True, use_bf16=True,
                  use_torch_compile=True, num_inference_steps=1),
}
ALIASES = {
    "vanilla": "baseline",
    "cached": "prefix_cache",
    "blurr_step1": "blurr",
    "step1": "blurr",
}


def apply_preset(cfg, preset: str) -> None:
    """Write the preset's toggles into ``cfg`` in place."""
    key = ALIASES.get(preset.lower().strip(), preset.lower().strip())
    if key not in PRESETS:
        raise ValueError(f"Unknown preset: {preset}")
    cfg["use_prefix_kv_cache"] = cfg.get("use_prefix_kv_cache", True)
    cfg.update(PRESETS[key])


def load_config(path: str) -> Config:
    """Load a YAML config; a relative path that does not exist is taken
    relative to the bundled config tree's parent, ``blurr_tpu/``
    (``config/eval/bridge.yaml``)."""
    p = Path(path)
    if not p.is_absolute() and not p.exists():
        p = config_root().parent / path
    return load_yaml(p)
