"""Sharded on-disk dataset format for Pi-0 flow-matching training.

Counterpart of ``blurr_tpu/data/shards.py`` (numpy only, as there): the
same files, byte for byte, so either package reads the other's
directories. Design goals, in order:

1. **Memory-mapped random access.** Each shard stores one plain ``.npy`` file
   per key (``shard-00000.actions.npy`` ...), loadable with
   ``np.load(mmap_mode="r")`` — a shuffled batch gather touches only the
   pages it reads, so datasets far larger than host RAM stream fine.
2. **Deterministic, O(1)-resumable iteration** (see loader.py): the manifest
   pins example counts so a (seed, consumed-batches) pair fully determines
   the stream.
3. **Self-describing.** ``manifest.json`` records keys/dtypes/shapes, the
   per-shard example counts, and (optionally) the dataset statistics used for
   p01/p99 normalization, so a training run needs only the directory path.

Why not ``.npz``: zipped archives cannot be memory-mapped, so every shard
read would materialize the full shard (images dominate) — the loader would
pay decompression + copy for rows it never touches.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

MANIFEST_NAME = "manifest.json"
_FORMAT_VERSION = 1


def _shard_prefix(i: int) -> str:
    return f"shard-{i:05d}"


class ShardWriter:
    """Append examples (or stacked batches) and write shards + manifest.

    Usage::

        with ShardWriter(out_dir, shard_size=512, statistics=stats) as w:
            for ex in episodes:          # dict of per-example arrays
                w.add(ex)
        # -> out_dir/shard-00000.<key>.npy ... + manifest.json
    """

    def __init__(self, out_dir, shard_size: int = 1024,
                 statistics: Optional[dict] = None):
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.shard_size = int(shard_size)
        self.statistics = statistics
        self._buffer: List[Dict[str, np.ndarray]] = []
        self._shards: List[dict] = []
        self._keys: Optional[dict] = None
        self._closed = False

    def _check_example(self, example: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        example = {k: np.asarray(v) for k, v in example.items()}
        sig = {
            k: {"dtype": str(v.dtype), "shape": list(v.shape)}
            for k, v in sorted(example.items())
        }
        if self._keys is None:
            self._keys = sig
        elif sig != self._keys:
            raise ValueError(
                f"example signature {sig} != first example's {self._keys}"
            )
        return example

    def add(self, example: Dict[str, np.ndarray]) -> None:
        """Add ONE example (arrays without a batch dimension)."""
        self._buffer.append(self._check_example(example))
        if len(self._buffer) >= self.shard_size:
            self._flush()

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Add a stacked batch: every value is [N, ...] with a shared N."""
        batch = {k: np.asarray(v) for k, v in batch.items()}
        ns = {v.shape[0] for v in batch.values()}
        if len(ns) != 1:
            raise ValueError(f"inconsistent batch sizes per key: {ns}")
        for i in range(ns.pop()):
            self.add({k: v[i] for k, v in batch.items()})

    def _flush(self) -> None:
        if not self._buffer:
            return
        prefix = _shard_prefix(len(self._shards))
        for key in self._keys:
            arr = np.stack([ex[key] for ex in self._buffer])
            np.save(self.out_dir / f"{prefix}.{key}.npy", arr)
        self._shards.append(
            {"prefix": prefix, "num_examples": len(self._buffer)}
        )
        self._buffer = []

    def close(self) -> dict:
        """Flush the tail shard and write ``manifest.json``; returns it."""
        if self._closed:
            raise RuntimeError("ShardWriter already closed")
        self._flush()
        if self._keys is None:
            raise ValueError("no examples were added")
        manifest = {
            "version": _FORMAT_VERSION,
            "num_examples": sum(s["num_examples"] for s in self._shards),
            "keys": self._keys,
            "shards": self._shards,
        }
        if self.statistics is not None:
            manifest["statistics"] = self.statistics
        with open(self.out_dir / MANIFEST_NAME, "w") as f:
            json.dump(manifest, f, indent=1)
        self._closed = True
        return manifest

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and not self._closed:
            self.close()
        return False


def write_dataset(out_dir, arrays: Dict[str, np.ndarray],
                  shard_size: int = 1024,
                  statistics: Optional[dict] = None) -> dict:
    """One-shot writer: ``arrays`` maps key -> [N, ...] stacked values."""
    with ShardWriter(out_dir, shard_size=shard_size,
                     statistics=statistics) as w:
        w.add_batch(arrays)
        return w.close()


def is_sharded_dataset(path) -> bool:
    return (Path(path) / MANIFEST_NAME).is_file()


class ShardedDataset:
    """Memory-mapped reader over a :class:`ShardWriter` directory.

    ``gather(key, idx)`` fancy-indexes GLOBAL example indices across shard
    boundaries; shard files open lazily (mmap) and stay open for the dataset
    lifetime, so repeated gathers touch only the OS page cache.
    """

    def __init__(self, root):
        self.root = Path(root)
        with open(self.root / MANIFEST_NAME) as f:
            self.manifest = json.load(f)
        if self.manifest.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported dataset version {self.manifest.get('version')!r}"
            )
        self.keys = dict(self.manifest["keys"])
        self.num_examples = int(self.manifest["num_examples"])
        self.statistics = self.manifest.get("statistics")
        counts = [int(s["num_examples"]) for s in self.manifest["shards"]]
        # offsets[i] = first global index of shard i; searchsorted-right on
        # offsets[1:] maps a global index to its shard
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        self._prefixes = [s["prefix"] for s in self.manifest["shards"]]
        self._mmaps: Dict[str, np.ndarray] = {}

    def _shard_array(self, shard: int, key: str) -> np.ndarray:
        name = f"{self._prefixes[shard]}.{key}.npy"
        arr = self._mmaps.get(name)
        if arr is None:
            arr = np.load(self.root / name, mmap_mode="r")
            self._mmaps[name] = arr
        return arr

    def _gather_plan(self, idx: np.ndarray):
        """Pure index math shared by every key of a batch: per touched shard,
        (shard, positions-in-request, sorted local rows)."""
        idx = np.asarray(idx, np.int64)
        if idx.ndim != 1:
            raise ValueError(f"idx must be 1-D, got shape {idx.shape}")
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_examples):
            raise IndexError(
                f"index out of range [0, {self.num_examples}): "
                f"[{idx.min()}, {idx.max()}]"
            )
        shard_ids = np.searchsorted(self._offsets[1:], idx, side="right")
        plan = []
        for shard in np.unique(shard_ids):
            sel = np.nonzero(shard_ids == shard)[0]
            local = idx[sel] - self._offsets[shard]
            order = np.argsort(local, kind="stable")
            plan.append((int(shard), sel[order], local[order]))
        return idx.size, plan

    def _gather_planned(self, key: str, n: int, plan) -> np.ndarray:
        key_info = self.keys[key]
        out = np.empty((n, *key_info["shape"]), dtype=np.dtype(key_info["dtype"]))
        # one mmap fancy-index per touched shard (sorted rows within a shard
        # read mostly-sequential pages)
        for shard, dest, local in plan:
            out[dest] = self._shard_array(shard, key)[local]
        return out

    def gather(self, key: str, idx: np.ndarray) -> np.ndarray:
        """Rows ``idx`` (global indices, any order, duplicates OK) of ``key``
        as a materialized array in the request's order."""
        n, plan = self._gather_plan(idx)
        return self._gather_planned(key, n, plan)

    def gather_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        # the searchsorted/unique/argsort plan is identical for every key —
        # compute it once per batch, not once per key
        n, plan = self._gather_plan(idx)
        return {k: self._gather_planned(k, n, plan) for k in self.keys}

    def example(self, i: int) -> Dict[str, np.ndarray]:
        b = self.gather_batch(np.asarray([i]))
        return {k: v[0] for k, v in b.items()}

    def iter_examples(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(self.num_examples):
            yield self.example(i)
