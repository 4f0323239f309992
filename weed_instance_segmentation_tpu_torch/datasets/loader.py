"""Host-side batching with background prefetch, and the copy to the card.

Port of ``weed_instance_segmentation_tpu/datasets/loader.py``: a background
thread loads and collates the next batches while the device works, in a
seed-deterministic order, and under data parallelism each process loads
only its own rows of every global batch. :func:`device_batches` moves each
numpy batch to the device, through pinned host memory with non-blocking
copies when the device is a GPU.

Its spans (``engine/trace.py``): ``loader.collate``, a batch loaded and
collated (on the prefetch thread); ``loader.wait``, the consumer's wait
for a prefetched batch; ``loader.to_device``, a batch's copy to the
device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from weed_instance_segmentation_tpu_torch.engine import trace


class DataLoader:
    """Iterates ``dataset`` in batches of ``batch_size`` collated by
    ``collate``; the last batch may be short. With ``shuffle`` the order of
    epoch e is drawn from ``seed + e``.

    ``process_count`` > 1 shards the input: every process computes the same
    global batch order and loads only rows [k·L, (k+1)·L) of each global
    batch, k = ``process_index`` and L = ``batch_size / process_count``. A
    short final batch is padded with repeats of its last index, so every
    process yields L samples; the batch's ``num_valid`` holds how many of
    them are real (:func:`mask_padding` marks the rest invalid)."""

    def __init__(self, dataset, batch_size: int, collate: Callable, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1):
        if process_count > 1 and batch_size % process_count:
            raise ValueError(
                f'batch_size {batch_size} not divisible by process_count {process_count}')
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
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
        with trace.span('loader.collate'):
            if self.process_count <= 1:
                return self.collate([self.dataset[int(i)] for i in idxs])
            local_bs = self.batch_size // self.process_count
            padded = np.concatenate([idxs, np.repeat(idxs[-1], self.batch_size - len(idxs))])
            lo = self.process_index * local_bs
            batch = self.collate([self.dataset[int(i)] for i in padded[lo:lo + local_bs]])
            batch['num_valid'] = int(np.clip(len(idxs) - lo, 0, local_bs))
            return batch

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
            with trace.span('loader.wait'):
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
    with trace.span('loader.to_device'):
        for key, value in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
    return out


def mask_padding(batch: dict) -> dict:
    """A static batch (``make_train_collate``) of a process-sharded loader
    without its ``num_valid``: the rows past it, repeats that pad the
    global batch, zeroed in ``sample_valid`` and ``instance_valid`` so they
    add nothing to the loss. Other batches pass through."""
    if 'num_valid' in batch and 'sample_valid' in batch:
        batch = dict(batch)
        n = batch.pop('num_valid')
        batch['sample_valid'] = batch['sample_valid'].copy()
        batch['instance_valid'] = batch['instance_valid'].copy()
        batch['sample_valid'][n:] = 0.0
        batch['instance_valid'][n:] = 0.0
    return batch


def device_batches(loader: Iterable[dict], device: torch.device) -> Iterator[dict]:
    """Each batch of ``loader`` through :func:`mask_padding`, moved to
    ``device`` by :func:`to_device`."""
    for batch in loader:
        yield to_device(mask_padding(batch), device)
