"""Small decorators.

Counterpart of ``blurr_tpu/utils/decorator.py``: ``conditional_decorator``
as it is there, and ``main_rank_only`` gated on ``torch.distributed``'s
rank where JAX reads ``jax.process_index``.
"""

from __future__ import annotations

from functools import wraps

import torch.distributed as dist


def conditional_decorator(dec, condition: bool):
    """Apply ``dec`` only when ``condition`` holds."""

    def decorator(func):
        if not condition:
            return func
        return dec(func)

    return decorator


def main_rank_only(func):
    """Run only on rank 0 of the initialised process group; returns None on
    every other rank. With no group initialised (one process) it runs."""

    @wraps(func)
    def wrapper(*args, **kwargs):
        if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
            return None
        return func(*args, **kwargs)

    return wrapper
