"""Batching loader: shuffling, host sharding, threaded decode, device prefetch
(counterpart of ``cross_scale_mae_tpu/data/loader.py``).

* **Epoch order**: the permutation of ``default_rng(seed * 100_003 +
  epoch)``, truncated with ``drop_last`` to a multiple of ``num_shards *
  batch_size`` before each shard takes its strided slice, as in the JAX
  package, so every shard runs the same number of steps.
* **Decode**: a thread pool per batch, and a producer thread that decodes
  batch k+1 while batch k is consumed. The native C++ loader of the JAX
  package is not ported (ROADMAP.md, queue 1 item 10).
* **Device prefetch**: :func:`device_prefetch` copies each batch into
  pinned host memory and to the device on a side CUDA stream, ``buffer``
  batches ahead; the consumer's stream waits on the copy's event, and
  ``record_stream`` keeps the device memory from being reused before the
  consumer's work on it has run.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from cross_scale_mae_torch.data.datasets import Dataset


class DataLoader:
    def __init__(self, dataset: Dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, num_threads: int = 4,
                 shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.shard_id = shard_id
        self.num_shards = num_shards

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed * 100_003 + epoch).permutation(n)
        else:
            order = np.arange(n)
        if self.drop_last:
            # Truncate the global order before striding, so every shard sees
            # the same number of steps.
            per_step = self.num_shards * self.batch_size
            order = order[:len(order) // per_step * per_step]
        return order[self.shard_id::self.num_shards]

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def max_shard_steps(self) -> int:
        """The largest shard's batch count: with drop_last=False the strided
        shards can differ by one sample, and so by one batch."""
        if self.drop_last:
            return self.steps_per_epoch()
        largest = (len(self.dataset) + self.num_shards - 1) // self.num_shards
        return (largest + self.batch_size - 1) // self.batch_size

    def padded_epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """:meth:`epoch`, then batches of no sample up to
        :meth:`max_shard_steps`: every shard runs the same number of eval
        steps, each of which is a collective, so a shard one batch short
        does not leave the others waiting (JAX cli/finetune.py:235-247)."""
        done = 0
        for batch in self.epoch(epoch):
            done += 1
            yield batch
        s, c = self.dataset.canvas_size, self.dataset.in_c
        for _ in range(self.max_shard_steps() - done):
            yield np.zeros((0, s, s, c), np.uint8), np.zeros((0,), np.int32)

    def _load_batch(self, idx: np.ndarray, pool: ThreadPoolExecutor | None
                    ) -> tuple[np.ndarray, np.ndarray]:
        s, c = self.dataset.canvas_size, self.dataset.in_c
        imgs = np.empty((len(idx), s, s, c), np.uint8)
        labels = np.empty((len(idx),), np.int32)

        def one(slot: int) -> None:
            img, label = self.dataset.load(int(idx[slot]))
            imgs[slot] = img.reshape(s, s, c)
            labels[slot] = label

        if pool is not None and len(idx) > 1:
            list(pool.map(one, range(len(idx))))
        else:
            for slot in range(len(idx)):
                one(slot)
        return imgs, labels

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yields (imgs uint8 (B, S, S, C), labels int32 (B,)) on the host."""
        order = self._epoch_indices(epoch)
        bs = self.batch_size
        batches = [order[i:i + bs] for i in range(0, len(order), bs)]
        if not batches:
            return
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def producer() -> None:
            pool = ThreadPoolExecutor(self.num_threads) if self.num_threads > 1 else None
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(self._load_batch(b, pool))
                q.put(None)
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(e)
            finally:
                if pool is not None:
                    pool.shutdown()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while (item := q.get()) is not None:
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # A consumer that stops early (max_steps) lets the producer end.
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


def device_prefetch(batches: Iterable, device: torch.device | str,
                    buffer: int = 2) -> Iterator[tuple[torch.Tensor, ...]]:
    """Move host batches (tuples of numpy arrays) to ``device``, ``buffer``
    batches ahead of the consumer.

    On a CUDA device each array is copied into pinned host memory and sent
    with a ``non_blocking`` copy on a side stream; the batch is handed over
    once the consumer's current stream waits on the copy's event, and each
    device tensor is recorded on that stream, so its memory is not reused
    until the work the consumer enqueues on it has run. (The caching host
    allocator holds each pinned buffer until its copy has completed.) On
    the CPU the arrays are wrapped as tensors."""
    device = torch.device(device)
    if device.type != "cuda":
        for item in batches:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in item)
        return
    stream = torch.cuda.Stream(device)
    pending: deque = deque()

    def hand_over(moved: tuple, event: torch.cuda.Event) -> tuple:
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in moved:
            t.record_stream(current)
        return moved

    for item in batches:
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory() for a in item]
        with torch.cuda.stream(stream):
            moved = tuple(h.to(device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        pending.append((moved, event))
        if len(pending) >= buffer:
            yield hand_over(*pending.popleft())
    while pending:
        yield hand_over(*pending.popleft())
