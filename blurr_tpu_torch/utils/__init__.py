"""Host-side utilities of the port (counterpart of ``blurr_tpu/utils``)."""
