"""BLURR on PyTorch and CUDA: the Pi-0 control step of ``blurr_tpu`` ported
to an NVIDIA Hopper GPU (H100).

The JAX package ``blurr_tpu`` is the reference this package is held
against. The layout mirrors it (``ops/…``, ``models/pi0/…``,
``serving/…``), and each module's docstring names its JAX counterpart.

Rules of the port:
- ``torch`` only: neither JAX nor anything of ``blurr_tpu`` is imported.
  What the port needs of the JAX package's plain-Python host modules it
  keeps as its own copies (``config/core.py``, ``paths.py``,
  ``serving/protocol.py``, ``serving/client.py``); the bundled YAML configs
  under ``blurr_tpu/config`` are read as data.
- The device is explicit: every constructor and entry point takes
  ``device`` and never picks one itself.
- Every Pallas kernel on the ported path is a CUDA kernel written by hand
  for ``sm_90a`` (``csrc/``), built at first use by ``ops/kernels.py``. A
  kernel's wrapper runs its plain PyTorch version only for CPU tensors;
  for CUDA tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
