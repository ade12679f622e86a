"""Fused GeGLU feed-forward block: a CUDA kernel for Hopper.

The kernel, ``csrc/fused_ffn.cu``, replaces the TPU kernel
``experiments/bench_fused_ffn.py:_kernel`` (wrapper ``fused_ffn``) and
computes its function with its numerics:

    a   = bf16(gelu_tanh(x @ Wg) * (x @ Wu))     fp32 dots, GeGLU and product in fp32
    out = bf16(a @ Wd)                           accumulated in fp32, rounded once

for x bf16 [M, H], Wg and Wu bf16 [H, I], Wd bf16 [I, H]. The TPU walks
I-blocks in order into one fp32 [M, H] scratch. The kernel runs two phases
on one stream, both ``wgmma`` fed by TMA: the gate and up product with the
GeGLU in its epilogue writes ``a`` once, bf16 [M, I], to a workspace that
stays in L2 (9.2 MB at the harness shape); the down product splits K = I
over a thread block cluster whose fp32 partials meet in shared memory and
add in slice order. ``grid`` gives both phases' geometry. The plain version ``fused_ffn_reference`` is the
three-matmul FFN in fp32 with ``a`` rounded to bf16: the kernel sums in
another order (tensor cores, K split), so the two differ by fp32 summation
noise, which may round an ``a`` or an output to the neighbouring bf16.

``fused_ffn`` launches the kernel for CUDA tensors, runs the plain version
only for CPU tensors, and counts its calls that launch in
``fused_ffn.launches``. Nothing on the control step calls it: JAX computes
the joint FFN in XLA, and the port with ``torch.matmul``.
"""

from __future__ import annotations

import ctypes

import torch

from blurr_tpu_torch.ops import kernels
from blurr_tpu_torch.ops.activations import geglu

_ROWS = 288  # rows of x per block: two warpgroups of 144 (the wgmma N)
_COLS = 64  # weight columns per block, both phases (the wgmma M)
_STEP = 64  # K per stage of the ring
_MIN_SLICE_STEPS = 4  # a slice of K gets at least 4 steps of 64
# the most clusters of 1..8 of the down phase's blocks an H100 SXM runs at
# once (``card_clusters`` on the card); index 0 unused
_CLUSTERS = (0, 132, 66, 39, 30, 22, 17, 15, 15)


def fused_ffn_reference(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        wd: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: bf16 [M, H]."""
    xf = x.float()
    a = geglu(xf @ wg.float(), xf @ wu.float()).to(torch.bfloat16)
    return (a.float() @ wd.float()).to(torch.bfloat16)


def grid(m: int, h: int, inter: int) -> tuple:
    """The kernel's geometry for an (M, H, I) FFN, as
    ``blurr_fused_ffn_grid`` computes it: ``((row_blocks, i_tiles),
    (row_blocks, s, h_tiles))``. Both phases run blocks of 288 rows by 64
    weight columns; the down phase splits K = I into S slices whose blocks
    form one cluster (1, S, 1). S is the one of 1..8 (each slice at least 4
    steps of 64) that least the steps of a slice times the waves its
    clusters take, the smaller on a tie."""
    row_blocks = -(-m // _ROWS)
    tiles, steps = row_blocks * (h // _COLS), inter // _STEP
    best, best_cost = 1, steps * -(-tiles // _CLUSTERS[1])
    for s in range(2, len(_CLUSTERS)):
        if steps < s * _MIN_SLICE_STEPS:
            break
        cost = -(-steps // s) * -(-tiles // _CLUSTERS[s])
        if cost < best_cost:
            best, best_cost = s, cost
    return (row_blocks, inter // _COLS), (row_blocks, best, h // _COLS)


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
    if m < 1 or h < 128 or h % 128 or inter < _COLS or inter % _COLS:
        raise ValueError(
            f"M={m}, H={h}, I={inter}: need M >= 1, H a multiple of 128 and I a "
            "multiple of 64"
        )
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA reads it)")


def fused_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor) -> torch.Tensor:
    """Returns bf16 [M, H] = bf16(bf16(gelu_tanh(x @ wg) * (x @ wu)) @ wd).
    CUDA tensors launch the kernel's two phases on the current stream (no
    synchronisation), with ``a`` in a bf16 [M, I] workspace; CPU tensors run
    the plain version."""
    _check(x, wg, wu, wd)
    if x.device.type == "cpu":
        return fused_ffn_reference(x, wg, wu, wd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on CUDA or CPU, not {x.device}")
    m, h = x.shape
    inter = wg.shape[1]
    lib = _library()
    a_ws = torch.empty(m, inter, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.blurr_fused_ffn(
            x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), a_ws.data_ptr(),
            out.data_ptr(), m, h, inter, stream,
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
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.blurr_fused_ffn_grid.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.blurr_fused_ffn_grid.restype = i
        lib.blurr_fused_ffn_clusters.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
        lib.blurr_fused_ffn_clusters.restype = i
        lib.blurr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.blurr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_grid(m: int, h: int, inter: int) -> tuple:
    """``blurr_fused_ffn_grid`` of the built kernel, in ``grid``'s form
    (the ``cuda`` tests hold the two equal). Builds the kernel."""
    out = (ctypes.c_int * 5)()
    if _library().blurr_fused_ffn_grid(m, h, inter, out):
        raise ValueError(f"fused_ffn takes no (M, H, I) = {(m, h, inter)}")
    return (out[0], out[1]), (out[2], out[3], out[4])


def card_clusters() -> tuple:
    """How many clusters of 1..8 of the down phase's blocks the current card
    runs at once (``cudaOccupancyMaxActiveClusters``), in ``_CLUSTERS``'s
    form. Builds the kernel; needs a card."""
    lib, out = _library(), ctypes.c_int()
    found = [0]
    for size in range(1, len(_CLUSTERS)):
        err = lib.blurr_fused_ffn_clusters(size, ctypes.byref(out))
        if err:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                               f"{lib.blurr_cuda_error_string(err).decode()} ({err})")
        found.append(out.value)
    return tuple(found)
