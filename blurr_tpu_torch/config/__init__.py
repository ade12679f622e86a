"""Configs of the port (counterpart of ``blurr_tpu/config``)."""

from blurr_tpu_torch.config.core import Config, load_yaml

__all__ = ["Config", "load_yaml"]
