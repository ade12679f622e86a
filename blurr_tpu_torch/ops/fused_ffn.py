"""Fused GeGLU feed-forward block: a CUDA kernel for Hopper.

The kernel, ``csrc/fused_ffn.cu``, replaces the TPU kernel
``experiments/bench_fused_ffn.py:_kernel`` (wrapper ``fused_ffn``) and
computes its function with its numerics:

    a   = bf16(gelu_tanh(x @ Wg) * (x @ Wu))     fp32 dots, product in fp32
    out = bf16(a @ Wd)                           accumulated in fp32

for x bf16 [M, H], Wg and Wu bf16 [H, I], Wd bf16 [I, H]. The TPU walks
I-blocks in order into one fp32 scratch; the kernel splits I into slices
across blocks, each writing an fp32 partial [16, H] to a workspace, and a
second pass sums the partials in slice order and rounds once. The plain
version ``fused_ffn_reference`` is the three-matmul FFN in fp32 with ``a``
rounded to bf16: the kernel sums in another order (tensor-core mma), so the
two differ by fp32 summation noise, which may round an ``a`` or an output to
the neighbouring bf16.

``fused_ffn`` launches the kernel for CUDA tensors, runs the plain version
only for CPU tensors, and counts its kernel launches in
``fused_ffn.launches``. Nothing on the control step calls it: JAX computes
the joint FFN in XLA, and the port with ``torch.matmul``.
"""

from __future__ import annotations

import ctypes

import torch

from blurr_tpu_torch.ops import kernels
from blurr_tpu_torch.ops.activations import geglu

_ROWS = 16  # rows of x per block of the kernel
_SUB = 64  # columns of I per step of a block
_WAVES = 3  # slices are chosen so that the blocks fill about this many waves


def fused_ffn_reference(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        wd: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: bf16 [M, H]."""
    xf = x.float()
    a = geglu(xf @ wg.float(), xf @ wu.float()).to(torch.bfloat16)
    return (a.float() @ wd.float()).to(torch.bfloat16)


def pick_slices(m: int, inter: int, sms: int) -> int:
    """How many slices of I the blocks split: about ``_WAVES`` blocks per SM
    over the ceil(M/16) row tiles, at most one slice per 64 columns."""
    tiles = -(-m // _ROWS)
    return max(1, min(inter // _SUB, _WAVES * sms // tiles))


def _check(x, wg, wu, wd) -> None:
    """What the kernel takes; anything else raises (nothing is copied)."""
    devices = {t.device for t in (x, wg, wu, wd)}
    if len(devices) != 1:
        raise ValueError(f"x, wg, wu and wd lie on different devices: {devices}")
    if any(t.dim() != 2 for t in (x, wg, wu, wd)):
        raise ValueError("fused_ffn takes x [M, H], wg and wu [H, I] and wd [I, H]")
    m, h = x.shape
    inter = wg.shape[1]
    if (tuple(wg.shape) != (h, inter) or tuple(wu.shape) != (h, inter)
            or tuple(wd.shape) != (inter, h)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, "
            f"wd {tuple(wd.shape)}: need wg, wu [H, I] and wd [I, H]"
        )
    if m < 1 or h % 128 or not 128 <= h <= 2048 or inter < _SUB or inter % _SUB:
        raise ValueError(
            f"M={m}, H={h}, I={inter}: need M >= 1, H a multiple of 128 up to "
            "2048 (the fp32 partial lives in shared memory) and I a multiple of 64"
        )
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel reads 16 bytes)")


def fused_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor) -> torch.Tensor:
    """Returns bf16 [M, H] = bf16(bf16(gelu_tanh(x @ wg) * (x @ wu)) @ wd).
    CUDA tensors launch the kernel's two passes on the current stream (no
    synchronisation); CPU tensors run the plain version."""
    _check(x, wg, wu, wd)
    if x.device.type == "cpu":
        return fused_ffn_reference(x, wg, wu, wd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on CUDA or CPU, not {x.device}")
    m, h = x.shape
    inter = wg.shape[1]
    slices = pick_slices(m, inter, torch.cuda.get_device_properties(x.device).multi_processor_count)
    lib = _library()
    ws = torch.empty(slices, m, h, dtype=torch.float32, device=x.device)
    out = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_fused_ffn(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), ws.data_ptr(),
            out.data_ptr(), m, h, inter, slices, stream,
        )
    if err:
        msg = lib.blurr_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_ffn kernel launch failed: {msg} ({err})")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0


def _library() -> ctypes.CDLL:
    lib = kernels.load("fused_ffn")
    fn = lib.blurr_fused_ffn
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib
