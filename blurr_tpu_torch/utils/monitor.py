"""Timing and memory logs of the eval agent.

Counterpart of the part of ``blurr_tpu/utils/monitor.py`` that the agent
uses: ``log_execution_time`` (unchanged) and the memory log, which reads
``torch.cuda.memory_allocated`` / ``max_memory_allocated`` on a card
(``log_allocated_tpu_memory`` reads the TPU's ``memory_stats`` there) and
says that a CPU run has no device memory instead of printing a number.
"""

from __future__ import annotations

import time
from functools import wraps

import torch


def log_allocated_device_memory(log=None, stage: str = "loading model", device=None) -> float:
    """GiB allocated by PyTorch on ``device`` after ``stage`` (0.0 on the
    CPU, which has no device memory to read)."""
    device = torch.device(device if device is not None else "cpu")
    emit = log.info if log else print
    if device.type != "cuda":
        emit(f"Allocated device memory after {stage}: none (running on {device})")
        return 0.0
    allocated = torch.cuda.memory_allocated(device) / 1024**3
    peak = torch.cuda.max_memory_allocated(device) / 1024**3
    emit(f"Allocated device memory after {stage}: {allocated:.2f} GiB "
         f"(peak {peak:.2f} GiB) on {torch.cuda.get_device_name(device)}")
    return allocated


def log_execution_time(logger=None):
    """Decorator logging wall-clock of a call."""

    def decorator(func):
        @wraps(func)
        def wrapper(*args, **kwargs):
            start = time.perf_counter()
            result = func(*args, **kwargs)
            elapsed = time.perf_counter() - start
            msg = f"{func.__name__} took {elapsed:.2f} seconds"
            (logger.info if logger else print)(msg)
            return result

        return wrapper

    return decorator
