"""The OpenVLA family (OpenVLA-7B, OpenVLA-OFT, MiniVLA) on PyTorch
(counterpart of ``blurr_tpu/models/openvla``)."""
