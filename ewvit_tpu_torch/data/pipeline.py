"""Batch loader and CUDA prefetcher (ewvit_tpu/data/pipeline.py).

:class:`BatchLoader` is a copy of the JAX package's: the same index order
for a seed (numpy's ``default_rng``), ``drop_last``, ``pad_last`` with
``true_len()``, and a thread pool that decodes ahead of the consumer, in
order. Batches are uint8 NHWC ``[B, T, H, W, 3]`` clips and int32 labels.
``shard=(index, count)`` (data parallelism: ``parallel.Mesh.batch_shard``)
keeps the global batches, their order, shuffle and padding, and yields
only rows ``[index*B/count, (index+1)*B/count)`` of each: a rank decodes
its own rows and no other's, and tells the dataset of the others
(``mark_used``, where the dataset keeps usage counts for its curriculum),
so every rank's dataset draws its next curriculum as the unsplit one does.

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
from typing import Iterator, Optional, Tuple

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
      shard: ``(index, count)``: yield this rank's ``batch_size // count``
        rows of each global batch (``batch_size`` must divide; needs
        ``drop_last`` or ``pad_last``, so that every rank's share has the
        same size). ``len`` and ``true_len`` stay global.
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
        shard: Optional[Tuple[int, int]] = None,
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
        if shard is not None:
            index, count = shard
            if batch_size % count or not 0 <= index < count:
                raise ValueError(f"batch_size {batch_size} does not split into {count} "
                                 f"equal shares (or shard index {index} is out of range)")
            if not (drop_last or pad_last):
                raise ValueError("a sharded loader needs drop_last or pad_last, so "
                                 "that every rank's share of a batch has one size")
        self.shard = shard
        self._clip_shape = None

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

    def _rows(self) -> int:
        """Rows of a batch this loader yields (this rank's share)."""
        return self.batch_size // (self.shard[1] if self.shard else 1)

    def _share(self, batch: np.ndarray) -> np.ndarray:
        """This rank's indices of a global batch; the dataset hears of the
        others' (``mark_used``)."""
        if self.shard is None:
            return batch
        per = self._rows()
        lo = self.shard[0] * per
        mine = batch[lo:lo + per]
        note = getattr(self.dataset, "mark_used", None)
        if note is not None:
            for i in np.concatenate([batch[:lo], batch[lo + per:]]):
                note(int(i))
        return mine

    def _collate(self, items) -> Tuple[np.ndarray, np.ndarray]:
        rows = self._rows()
        if not items:     # a padded tail that holds none of this rank's rows
            if self._clip_shape is None:
                self._clip_shape = np.shape(self.dataset[0][0])
            return (np.zeros((rows, *self._clip_shape), np.uint8),
                    np.zeros(rows, np.int32))
        clips, labels = zip(*items)
        frames = np.stack(clips)  # [B, T, H, W, 3]
        self._clip_shape = frames.shape[1:]
        if self.pad_last and frames.shape[0] < rows:
            pad = rows - frames.shape[0]
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
        batches = [self._share(b) for b in batches]
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
