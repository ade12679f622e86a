"""Deterministic, resumable, prefetching batch loader over sharded datasets.

Counterpart of ``blurr_tpu/data/loader.py``. The stream is a pure function
of ``(dataset, batch_size, seed, shuffle)``: batch ``t`` comes from epoch
``t // batches_per_epoch`` whose example order is
``RandomState((seed * 1000003 + epoch) % 2**31).permutation(N)``, the JAX
package's, so both packages hand out the same batches. Exact training
resume is free: ``--resume-state`` restores the training state and sets
the loader's consumed-batch counter to the saved step (O(1), no replay).

Host-side pipelining happens at two levels:

- ``prefetch=k`` runs the gather+transform in a background thread, ``k``
  batches ahead, so shard IO and image resizing overlap device compute.
- :func:`device_prefetch` wraps any batch iterator and keeps ``depth``
  batches already on their way to the device: pinned host memory, copied
  with ``non_blocking`` on the current stream, hiding the host->device copy
  behind the previous step.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .shards import ShardedDataset

Batch = Dict[str, np.ndarray]


class ShardedBatchLoader:
    """Shuffled batch stream with an O(1)-restorable position.

    Parameters
    ----------
    dataset: path to a :class:`ShardWriter` directory, or a ShardedDataset.
    batch_size: fixed batch size; the last partial batch of each epoch is
        dropped (static shapes, as in JAX).
    seed / shuffle: per-epoch permutation ``RandomState(seed*1000003 + epoch)``
        (identity order when ``shuffle=False``).
    transform: optional ``batch -> batch`` host function (e.g.
        :class:`~blurr_tpu_torch.data.transform.Pi0TrainTransform`).
    prefetch: 0 = synchronous; k > 0 = background thread keeps up to k
        prepared batches queued.
    example_range: optional (lo, hi) half-open window of dataset indices
        this loader draws from — the train/validation split mechanism
        (train gets [0, N-k), validation [N-k, N)). The stream stays a pure
        function of (seed, consumed, range), so exact resume is unaffected.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 shuffle: bool = True,
                 transform: Optional[Callable[[Batch], Batch]] = None,
                 prefetch: int = 0,
                 example_range: Optional[tuple] = None):
        self.dataset = (
            dataset if isinstance(dataset, ShardedDataset)
            else ShardedDataset(dataset)
        )
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.batch_size = int(batch_size)
        lo, hi = example_range or (0, self.dataset.num_examples)
        if not (0 <= lo < hi <= self.dataset.num_examples):
            raise ValueError(
                f"example_range {example_range} outside "
                f"[0, {self.dataset.num_examples})"
            )
        self._lo, self._hi = int(lo), int(hi)
        self.num_examples = self._hi - self._lo
        self.batches_per_epoch = self.num_examples // self.batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"window has {self.num_examples} examples; "
                f"< one batch of {batch_size}"
            )
        self.seed = int(seed)
        self.shuffle = bool(shuffle)
        self.transform = transform
        self._consumed = 0  # batches handed to the caller so far
        self._perm_epoch = -1
        self._perm: Optional[np.ndarray] = None
        self._prefetch = int(prefetch)
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()

    # ---- deterministic addressing -------------------------------------

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if epoch != self._perm_epoch:
            if self.shuffle:
                rs = np.random.RandomState(
                    (self.seed * 1000003 + epoch) % (2 ** 31)
                )
                self._perm = self._lo + rs.permutation(self.num_examples)
            else:
                self._perm = np.arange(self._lo, self._hi)
            self._perm_epoch = epoch
        return self._perm

    def _batch_at(self, t: int) -> Batch:
        epoch, b = divmod(t, self.batches_per_epoch)
        perm = self._epoch_perm(epoch)
        idx = perm[b * self.batch_size:(b + 1) * self.batch_size]
        batch = self.dataset.gather_batch(idx)
        if self.transform is not None:
            batch = self.transform(batch)
        return batch

    # ---- position ------------------------------------------------------

    def state(self) -> dict:
        """Everything needed to resume: the consumed-batch count (the rest
        of the stream is derivable from the constructor arguments)."""
        return {"consumed": self._consumed}

    def restore(self, state) -> None:
        consumed = state["consumed"] if isinstance(state, dict) else int(state)
        if consumed < 0:
            raise ValueError(f"consumed must be >= 0, got {consumed}")
        self._stop_producer()
        self._consumed = int(consumed)

    # ---- iteration -----------------------------------------------------

    def next_batch(self) -> Batch:
        if self._prefetch > 0:
            self._ensure_producer()
            t, batch = self._q.get()
            if isinstance(batch, BaseException):
                # a producer failure (corrupt shard, transform error) must
                # surface HERE, not hang the consumer on an empty queue
                self._stop_producer()
                raise batch
            # the producer restarts from self._consumed after restore(), so
            # indices always arrive in consumption order
            if t != self._consumed:
                raise RuntimeError(
                    f"prefetch stream out of sync: got batch {t}, expected "
                    f"{self._consumed}"
                )
        else:
            batch = self._batch_at(self._consumed)
        self._consumed += 1
        return batch

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:  # infinite stream (epochs wrap)
        return self.next_batch()

    # ---- producer thread -------------------------------------------------

    def _ensure_producer(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        # PER-GENERATION stop event + queue, captured as locals: a previous
        # producer that outlived join(timeout) (slow cold-page gather) keeps
        # ITS stop/queue and can never push stale-indexed batches into a new
        # generation's queue — which would break the exact-resume stream
        stop = self._stop = threading.Event()
        q = self._q = queue.Queue(maxsize=self._prefetch)
        start = self._consumed

        def run():
            t = start
            while not stop.is_set():
                try:
                    batch = self._batch_at(t)
                except BaseException as exc:  # surface in next_batch()
                    q.put((t, exc))
                    return
                while not stop.is_set():
                    try:
                        q.put((t, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                t += 1

        self._thread = threading.Thread(
            target=run, name="blurr-data-prefetch", daemon=True
        )
        self._thread.start()

    def _stop_producer(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        # unblock a producer waiting on put()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
        self._thread = None
        self._q = None

    def close(self) -> None:
        self._stop_producer()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def device_prefetch(batches: Iterator[Batch], depth: int = 2,
                    device="cuda") -> Iterator[Dict]:
    """Yield batches as tensors on ``device``, keeping ``depth`` copies in
    flight. On a CUDA device each array goes to pinned host memory and then
    to the card with ``non_blocking=True`` on the current stream (the JAX
    package's async ``jax.device_put``): pulling the next host batch and
    enqueueing its copy before the caller takes the current one overlaps
    host IO and the transfer with device compute. On the CPU the arrays are
    wrapped as they are."""
    import collections

    import torch

    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    device = torch.device(device)

    def put(batch: Batch) -> Dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    buf = collections.deque()
    it = iter(batches)
    try:
        while len(buf) < depth:
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out
