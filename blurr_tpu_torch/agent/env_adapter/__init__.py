"""Env adapters of the port (counterpart of ``blurr_tpu/agent/env_adapter``)."""
