"""Host-side batching with background prefetch, and the copy to the card.

Port of ``weed_instance_segmentation_tpu/datasets/loader.py`` (single
process; per-host sharding waits for the data-parallel slice): a background
thread loads and collates the next batches while the device works, in a
seed-deterministic order. :func:`device_batches` moves each numpy batch to
the device, through pinned host memory with non-blocking copies when the
device is a GPU.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


class DataLoader:
    """Iterates ``dataset`` in batches of ``batch_size`` collated by
    ``collate``; the last batch may be short. With ``shuffle`` the order of
    epoch e is drawn from ``seed + e``."""

    def __init__(self, dataset, batch_size: int, collate: Callable, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The next pass draws epoch ``epoch``'s order (seed + epoch), so a
        run resumed at epoch k sees the batches an uninterrupted run would."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _index_batches(self) -> list:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        return [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]

    def _materialize(self, idxs) -> dict:
        return self.collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self._epoch += 1
        return prefetch_iterator((self._materialize(idxs) for idxs in batches), self.prefetch)


def prefetch_iterator(it: Iterable, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread, keeping up to ``depth`` items ready
    ahead of the consumer. Exceptions in ``it`` re-raise in the consumer;
    abandoning the iterator stops the thread."""
    if depth <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
        except Exception as e:  # re-raised in the consumer
            put(e)
            return
        put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy batch → tensors on ``device``; to a GPU through pinned memory
    with non-blocking copies (ordered on the current stream, so a step
    launched after this reads the copied data)."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == 'cuda':
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def device_batches(loader: Iterable[dict], device: torch.device) -> Iterator[dict]:
    """Each batch of ``loader`` moved to ``device`` by :func:`to_device`."""
    for batch in loader:
        yield to_device(batch, device)
