"""Tensor primitives of the port (counterpart of ``blurr_tpu/ops``)."""
