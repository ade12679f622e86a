"""Serving of the port (counterpart of ``blurr_tpu/serving``)."""
