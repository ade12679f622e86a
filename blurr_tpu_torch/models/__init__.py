"""Model families of the port (counterpart of ``blurr_tpu/models``)."""
