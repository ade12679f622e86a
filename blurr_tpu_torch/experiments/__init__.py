"""The experiments of the port: counterparts of the harnesses in
``experiments/`` whose kernels were written for the TPU (the low-bit
matmuls and the fused GeGLU FFN), run on the card as ``python -m
blurr_tpu_torch.experiments.<name>``."""
