"""Host batching with a prefetch thread, for one process's device.

Port of ``objcavit_tpu/data/loader.py::DeviceLoader``: batches of
``batch_size`` samples, in order or (``shuffle``) in an order drawn each
epoch from ``np.random.default_rng(seed)``, whose one stream also feeds each
sample's draws, as in the JAX package. A short final batch is padded with
the epoch's first samples; ``sample_valid`` marks the real ones.
``host_hook(batch_np)`` (the object provider) runs on the host batch in the
prefetch thread, or inline when ``synchronous``; its '_'-prefixed keys
(detection annotations) go to the batch's meta, not to the device. Host
arrays become tensors, pinned when the device is a card, and are copied to
``device`` with ``non_blocking=True``. Iterating yields ``(batch, meta)`` as
in the JAX package: ``batch`` holds 'image', 'depth', 'sample_valid' and the
hook's entries (nested dicts of tensors), ``meta`` the per-sample 'focal',
'image_path' and 'depth_path'. A dataset whose ``get_batch`` returns a
batch (``DepthDataset``'s old_dl train path: threaded decode and the host
core's assembly) gives it whole; else the loader reads sample by sample.
In a process group of P processes (``parallel/distributed.py``) every
process draws the same order from the same seed and loads rows
``[p::P]`` of each global batch of ``batch_size``, ``sample_valid``
included (JAX's interleave, ``objcavit_tpu/data/loader.py:60-80``); a
``batch_size`` that P does not divide raises ValueError. Each process's
samples draw from its own stream, as in the JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from objcavit_torch.parallel.distributed import process_local_indices
from objcavit_torch.parallel.mesh import current_grid
from objcavit_torch.utils.device import card_device

PREFETCH = 2  # batches the worker keeps ready
SEED = 42  # the order's and the samples' generator (the eval samples draw nothing)


def to_device(tree, device: torch.device):
    """Numpy arrays (in nested dicts) -> tensors on ``device``, through pinned
    host memory when the device is a card."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class DeviceLoader:
    def __init__(self, dataset: Any, batch_size: int, device="cuda", shuffle: bool = False,
                 seed: int = SEED, host_hook=None, synchronous: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = card_device(device)
        self.shuffle = shuffle
        self.host_hook = host_hook
        self.synchronous = synchronous
        self._rng = np.random.default_rng(seed)
        grid = current_grid()  # the data axis: the ranks of one model index share rows
        self._pid, self._pc = grid.data_index, grid.n_data
        if self._pc > 1 and batch_size % self._pc != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide the "
                f"{self._pc}-process run (each process loads "
                f"batch_size/process_count samples)"
            )

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def host_batches(self) -> Iterator[tuple[dict, dict]]:
        """An epoch's host batches before the hook, drawn from the stream:
        the order, then each batch's samples (``dataset.get_batch`` where it
        gives the batch, else ``dataset.get`` a sample); in a process group,
        this process's rows of each global batch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idxs = order[start:start + self.batch_size]
            valid = np.ones(len(idxs), bool)
            if len(idxs) < self.batch_size:
                pad = order[:self.batch_size - len(idxs)]
                valid = np.concatenate([valid, np.zeros(len(pad), bool)])
                idxs = np.concatenate([idxs, pad])
            if self._pc > 1:
                idxs = process_local_indices(idxs, self._pid, self._pc)
                valid = process_local_indices(valid, self._pid, self._pc)
            get_batch = getattr(self.dataset, "get_batch", None)
            whole = None if get_batch is None else get_batch(idxs, self._rng)
            if whole is not None:
                batch, meta = whole
                batch["sample_valid"] = valid
                yield batch, meta
                continue
            samples = [self.dataset.get(int(i), self._rng) for i in idxs]
            batch = {
                "image": np.stack([s["image"] for s in samples]),
                "depth": np.stack([s["depth"] for s in samples]),
                "sample_valid": valid,
            }
            meta = {k: [s[k] for s in samples] for k in ("focal", "image_path", "depth_path")}
            yield batch, meta

    def _ready(self, batch: dict, meta: dict) -> tuple[dict, dict]:
        if self.host_hook is not None:
            extra = self.host_hook(batch)
            for k in [k for k in extra if k.startswith("_")]:
                meta[k] = extra.pop(k)
            batch.update(extra)
        return to_device(batch, self.device), meta

    def __iter__(self):
        if self.synchronous:
            for batch, meta in self.host_batches():
                yield self._ready(batch, meta)
            return

        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop, done = object(), threading.Event()

        def worker():
            try:
                for batch, meta in self.host_batches():
                    if done.is_set():
                        return
                    q.put(self._ready(batch, meta))
                q.put(stop)
            except BaseException as e:  # surface errors to the consumer
                q.put(e)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early (a --debug limit) ends the worker:
            # emptying the queue frees its pending put, after which it sees
            # ``done`` before loading the next batch
            done.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
