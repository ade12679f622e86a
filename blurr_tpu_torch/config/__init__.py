"""Configs of the port (counterpart of ``blurr_tpu/config``)."""

from blurr_tpu_torch.config.core import Config, instantiate, load_yaml, register

__all__ = ["Config", "instantiate", "load_yaml", "register"]
