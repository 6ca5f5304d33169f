"""Batch loader and CUDA prefetcher (ewvit_tpu/data/pipeline.py).

:class:`BatchLoader` is a copy of the JAX package's: the same index order
for a seed (numpy's ``default_rng``), ``drop_last``, ``pad_last`` with
``true_len()``, and a thread pool that decodes ahead of the consumer, in
order. Batches are uint8 NHWC ``[B, T, H, W, 3]`` clips and int32 labels.

:class:`DevicePrefetcher` is rebuilt for CUDA: each batch's clips go into
pinned host memory and are copied to the card with ``non_blocking`` on a
side stream, one batch ahead of the consumer. Before a batch is handed out
the consumer's stream waits on an event recorded after its copy, and the
device tensor is recorded on the consumer's stream (``record_stream``) so
that the caching allocator does not reuse it while the consumer's work is
queued; each pinned source stays referenced until its copy's event has
completed. Labels stay on the host, as the JAX package's train and eval
loops keep them (``put_labels=False``) for the metrics. For the CPU it
passes batches through as they are.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from ewvit_tpu_torch.device import DeviceLike, resolve_device


class BatchLoader:
    """Iterates ``(frames [B,T,H,W,3] uint8, labels [B] int32)`` batches.

    Args:
      dataset: map-style dataset with __len__/__getitem__ -> (clip, label).
      batch_size: clips per batch.
      shuffle: reshuffle indices each epoch (numpy RNG, seeded).
      drop_last: drop the ragged tail batch (the training default; eval pads
        instead via ``pad_last``).
      num_workers: decode threads. cv2 releases the GIL during imdecode/resize
        so threads scale on a multi-core host; 0 = synchronous.
      prefetch: max batches resident ahead of the consumer.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def true_len(self) -> int:
        """Number of real (non-pad) items this loader yields.

        The loader protocol ``evaluate()``/``Trainer`` use to trim
        ``pad_last`` rows out of metrics; wrapper loaders that expand items
        (e.g. plot_celebdf_roc.PerFrameLoader) override it.
        """
        return len(self.dataset)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _collate(self, items) -> Tuple[np.ndarray, np.ndarray]:
        clips, labels = zip(*items)
        frames = np.stack(clips)  # [B, T, H, W, 3]
        if self.pad_last and frames.shape[0] < self.batch_size:
            pad = self.batch_size - frames.shape[0]
            frames = np.concatenate(
                [frames, np.zeros((pad,) + frames.shape[1:], frames.dtype)])
            labels = labels + (0,) * pad
        return frames, np.asarray(labels, np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._epoch_indices()
        self._epoch += 1
        batches = [
            idx[i:i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.num_workers <= 0:
            for b in batches:
                yield self._collate([self.dataset[int(i)] for i in b])
            return

        # Pipelined decode: a worker pool fills a bounded queue ahead of the
        # consumer; batch order is preserved.
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(
                            self.dataset.__getitem__, [int(i) for i in b]))
                        q.put(self._collate(items))
                except BaseException as e:  # surface in the consumer
                    q.put(e)
                    return
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class DevicePrefetcher:
    """Wraps a batch iterator and copies the next batch's clips to the card
    while the consumer works on the current one.

    Batches are ``(frames, labels, *rest)`` tuples: frames go to the device
    (a uint8 tensor there), labels and ``rest`` pass through. On the CPU
    every batch passes through unchanged.
    """

    def __init__(self, loader, device: DeviceLike = "cuda"):
        self.loader = loader
        self.device = resolve_device(device)

    def _put(self, batch, stream, in_flight):
        """Queue the copy of ``batch``'s clips on ``stream``; the pinned
        source and the copy's event go into ``in_flight``."""
        frames, *rest = batch
        host = torch.from_numpy(np.ascontiguousarray(frames)).pin_memory()
        with torch.cuda.stream(stream):
            moved = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        in_flight.append((host, done))
        return (moved, *rest), done

    @staticmethod
    def _hand_over(item):
        """The batch, safe to use on the current stream."""
        batch, done = item
        consumer = torch.cuda.current_stream()
        consumer.wait_event(done)
        batch[0].record_stream(consumer)
        return batch

    def __iter__(self):
        if self.device.type != "cuda":
            yield from self.loader
            return
        stream = torch.cuda.Stream(self.device)
        in_flight: collections.deque = collections.deque()
        pending = None
        try:
            for batch in self.loader:
                queued = self._put(batch, stream, in_flight)
                if pending is not None:
                    yield self._hand_over(pending)
                pending = queued
                while in_flight and in_flight[0][1].query():
                    in_flight.popleft()       # the copy is done: release its source
            if pending is not None:
                yield self._hand_over(pending)
        finally:
            for _, done in in_flight:
                done.synchronize()
