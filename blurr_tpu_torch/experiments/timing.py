"""Timing on the card, and the least time the card could take, shared by
the experiment entry points and ``chip_smoke.py``.

``events_ms`` times eager calls with CUDA events; for a call shorter than its
host work (a wrapper's checks and launch) it times the host. ``graph_ms``
captures the calls in one CUDA graph and replays it, so it times the device
alone. ``card`` is the card's name and power limit as ``nvidia-smi`` gives
them: every time is printed beside it, since a card set below its power
limit runs slower under load. ``bound`` is a function's least time on an
H100 SXM from its shapes and the data sheet's peaks.
"""

from __future__ import annotations

import subprocess

import torch

# the H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W); fp32
# is the rate outside the tensor cores (full fp32, no TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def events_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` eager
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph and replayed, timed with CUDA events. No host work runs
    between the launches, so a kernel shorter than its wrapper's host time
    is timed as the device runs it (``events_ms`` then times the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def bound(inputs, outputs, ops: float, kind: str) -> dict:
    """The least time the card could take for a function: the larger of the
    bytes it must move (each input tensor read once, each output written
    once) over the memory rate, and its ``ops`` operations over the peak rate
    of their ``kind`` ("bf16", "int8" or "fp32"). Returns ``bound_ms`` and
    ``bound_by`` ("bytes" or "operations")."""
    n_bytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
