"""Batching, background decode and double-buffered copies to the device.

Counterpart of ``sradsgan_tpu/data/loader.py``.  :class:`DataLoader` walks a
dataset in the same order for the same seed as the JAX package's, decoding
on a thread pool while the device computes.  :func:`device_prefetch` moves
its batches to the device ahead of consumption: on a CUDA device a producer
thread fills pinned host buffers (NHWC -> NCHW on the way) and copies them
``non_blocking`` on a side stream, two batches ahead; the consumer's
stream waits on each batch's event before the batch is handed out.  On the
CPU the batches pass through as NCHW tensors.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

ARRAY_KEYS = ("lr", "hr", "bc")


def _collate(samples) -> Dict[str, np.ndarray]:
    batch = {k: np.stack([s[k] for s in samples]) for k in ARRAY_KEYS}
    batch["path"] = [s["path"] for s in samples]
    return batch


class DataLoader:
    """Epoch iterator over a dataset yielding collated NHWC numpy batches.

    Each pass over the loader shuffles with
    ``np.random.default_rng(seed + passes so far)``.  With ``augment_rng``
    image ``idx`` is loaded with ``np.random.default_rng(seed * 100003 +
    idx)`` as the generator of its random augmentation (else with none), as
    the JAX loader does: the draw depends on the index and not on the
    pass, so an image gets the same augmentation every epoch.

    ``shard_index``/``shard_count`` split the data over the ranks of a data
    mesh as the JAX loader does: every rank shuffles with the same seed and
    takes ``order[shard_index::shard_count]``, so with ``batch_size`` the
    local batch b, step i of the ranks together covers positions
    ``i*b*count ... (i+1)*b*count - 1`` of the order, the one-process
    loader's batch i at batch ``b * count``.  With ``drop_last`` every shard
    yields ``len(dataset) // (b * count)`` batches, as many as that loader:
    a stride's share of the tail may differ by one image between shards,
    and a rank that took one step more than the others would wait in its
    collectives forever.  Without ``drop_last`` (a sweep) each shard yields
    all its images."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 seed: int = 0, augment_rng: bool = False,
                 shard_index: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.augment_rng = augment_rng
        self.shard_index = shard_index
        self.shard_count = max(shard_count, 1)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // (self.batch_size * self.shard_count)
        n = (n - self.shard_index + self.shard_count - 1) // self.shard_count
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.shard_index::self.shard_count]
        n = len(order)
        self._epoch += 1

        stop = len(self) * self.batch_size if self.drop_last else n
        indices = [order[i:i + self.batch_size]
                   for i in range(0, stop, self.batch_size)]
        if not indices:
            return

        def load_one(idx):
            rng = (np.random.default_rng(self.seed * 100003 + int(idx))
                   if self.augment_rng else None)
            return self.dataset.load(int(idx), rng)

        with ThreadPoolExecutor(self.num_workers) as pool:
            # Pipeline: batch i + 1 decodes while batch i is consumed.
            pending = pool.map(load_one, indices[0])
            for nxt in indices[1:]:
                samples = list(pending)
                pending = pool.map(load_one, nxt)
                yield _collate(samples)
            yield _collate(list(pending))


class _End:
    """End-of-stream marker; carries a producer exception to re-raise."""

    def __init__(self, err=None):
        self.err = err


class _PinnedRing:
    """Pinned host buffers for ``slots`` batches in flight, and the side
    stream their copies run on.  A slot is refilled only after the copy
    that last read it has finished."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [{} for _ in range(slots)]
        self.copied = [None] * slots
        self.i = 0

    def put(self, batch: Dict[str, np.ndarray]):
        """Start the copies of one NHWC numpy batch; returns the NCHW device
        tensors and the event that marks their arrival."""
        i, self.i = self.i, (self.i + 1) % len(self.slots)
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        slot, out = self.slots[i], {}
        with torch.cuda.stream(self.stream):
            for key, value in batch.items():
                src = torch.from_numpy(value).permute(0, 3, 1, 2)
                buf = slot.get(key)
                if buf is None or buf.shape != src.shape:
                    buf = slot[key] = torch.empty(
                        src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                out[key] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.copied[i] = event
        return out, event


DEPTH = 2  # batches the feed prepares ahead of the consumer


def device_prefetch(iterator, device: torch.device | str):
    """Yield the iterator's batches as dicts of NCHW float tensors on
    ``device`` (plus ``path``), prepared ``DEPTH`` batches ahead by a
    producer thread.  A producer's exception is re-raised in the consumer.
    Closing the generator early stops the producer."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        err = None
        try:
            # DEPTH queued, one with the consumer, one being filled
            ring = (_PinnedRing(device, DEPTH + 2)
                    if device.type == "cuda" else None)
            for batch in iterator:
                paths = batch.pop("path", None)
                if ring is None:
                    item = ({k: torch.from_numpy(v).permute(0, 3, 1, 2)
                             .contiguous() for k, v in batch.items()}, None)
                else:
                    item = ring.put(batch)
                if paths is not None:
                    item[0]["path"] = paths
                if not offer(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            err = e
        offer(_End(err))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _End):
                if item.err is not None:
                    raise item.err
                return
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for value in batch.values():
                    if isinstance(value, torch.Tensor):
                        # allocated on the side stream, used on this one
                        value.record_stream(current)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
