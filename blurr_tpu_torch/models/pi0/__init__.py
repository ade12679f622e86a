"""Pi-0 on PyTorch (counterpart of ``blurr_tpu/models/pi0``)."""
