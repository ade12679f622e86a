"""Training data pipeline: sharded mmap datasets, deterministic resumable
loading, host/device prefetch, and deployment-exact preprocessing.

Counterpart of ``blurr_tpu/data``: the port keeps its own copy (it imports
nothing of the JAX package), byte-compatible with it."""

from .loader import ShardedBatchLoader, device_prefetch
from .shards import (
    MANIFEST_NAME,
    ShardedDataset,
    ShardWriter,
    is_sharded_dataset,
    write_dataset,
)
from .transform import Pi0TrainTransform, transform_for_config

__all__ = [
    "MANIFEST_NAME",
    "Pi0TrainTransform",
    "ShardedBatchLoader",
    "ShardedDataset",
    "ShardWriter",
    "device_prefetch",
    "is_sharded_dataset",
    "transform_for_config",
    "write_dataset",
]
