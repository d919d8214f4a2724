"""Host-side data loader (counterpart of ``diffusioniqt_tpu/data/loader.py``,
whose batching, shuffling and prefetch thread it copies).

Replaces the reference's torch ``DataLoader`` + ``my_collate``
(reference ``data.py:42-48``): items that return ``None`` (rejected
patches) are dropped from the batch; an all-``None`` batch yields ``None``.
Batches are tuples of numpy arrays, and the shuffle order comes from a
seeded numpy generator, so a test holds the two loaders' batches equal.

``prefetch > 0`` overlaps host-side loading (NIfTI IO, patch crops,
normalisation) with device compute via a background thread and a bounded
queue. :func:`device_transfer_map` is the trainer's worker map (the JAX
trainer's ``_transfer_map``, trainer.py:255-272): it casts to
``Train.transfer_dtype`` when one is set, pins the batch and copies it to
the card ``non_blocking``. One batch's items, collate and worker map are
the recorder's span ``loader.batch`` (``utils/profiling.py``), on the
prefetch thread when there is one.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from diffusioniqt_tpu_torch.utils import profiling


def device_transfer_map(device, transfer_dtype: Optional[str] = None):
    """Worker map: each array of a batch to a tensor on ``device``, cast to
    ``transfer_dtype`` (a ``torch`` dtype name, e.g. ``"bfloat16"``) first
    when one is given, through pinned memory with a ``non_blocking`` copy
    when ``device`` is a CUDA device. A tensor already on ``device`` passes
    through."""
    device = torch.device(device)
    dtype = None if transfer_dtype is None else getattr(torch, transfer_dtype, None)
    if transfer_dtype is not None and not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown transfer dtype {transfer_dtype!r}")

    def to_device(batch):
        out = []
        for a in batch:
            if isinstance(a, torch.Tensor) and a.device == device:
                out.append(a)
                continue
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
            if dtype is not None:
                t = t.to(dtype)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t.to(device))
        return tuple(out)

    return to_device


class _PrefetchIterator:
    """Drains ``iterable`` on a daemon thread into a bounded queue.

    The worker closure deliberately does NOT capture ``self``: when the
    consumer drops the iterator mid-epoch, ``__del__`` can fire, set the
    stop event, and the worker unblocks from its bounded-``put`` wait and
    exits — instead of pinning the dataset and in-flight batches forever.
    """

    _SENTINEL = object()

    def __init__(self, iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err_box: list = []

        def worker(it, q, stop, err_box, sentinel):
            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # propagate to the consumer
                err_box.append(e)
            finally:
                put(sentinel)

        self._thread = threading.Thread(
            target=worker,
            args=(iterable, self._q, self._stop, self._err_box,
                  self._SENTINEL),
            daemon=True,
        )
        self._thread.start()

    def close(self):
        self._stop.set()
        # drain so a worker blocked between Full-checks sees the event fast
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return item


def collate_drop_none(items):
    """Stack tuple-of-array items, dropping Nones (reference ``my_collate``)."""
    items = [it for it in items if it is not None]
    if not items:
        return None
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(
            np.stack([np.asarray(it[i]) for it in items], axis=0)
            for i in range(len(first))
        )
    return np.stack([np.asarray(it) for it in items], axis=0)


class DataLoader:
    """Iterates a map-style dataset in batches with optional shuffling."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn=collate_drop_none,
                 seed: int = 0, prefetch: int = 0, worker_map=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        # applied to each collated batch before it is handed to the
        # consumer; with prefetch > 0 it runs on the worker thread, so the
        # cast, pin and copy of :func:`device_transfer_map` overlap the
        # previous step's device compute
        self.worker_map = worker_map
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        # advance the dataset's epoch so per-(epoch, idx)-seeded crops vary
        # across passes without touching the global np.random stream
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        if self.prefetch > 0:
            return _PrefetchIterator(self._iterate(), depth=self.prefetch)
        return self._iterate()

    def _iterate(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            with profiling.span("loader.batch"):
                batch = self.collate_fn([self.dataset[int(i)] for i in idx])
                if batch is not None and self.worker_map is not None:
                    batch = self.worker_map(batch)
            if batch is None:
                continue
            yield batch
