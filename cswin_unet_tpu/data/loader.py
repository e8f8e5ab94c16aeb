"""Host data loading: threaded prefetching batcher + device double-buffering.

Replaces torch ``DataLoader(num_workers=8, pin_memory=True)``
(reference ``trainer.py:35``) with a pipeline that keeps the device fed:

  * a thread pool decodes/augments samples ahead of consumption (numpy,
    scipy and h5py release the GIL in their hot paths);
  * batches are assembled into contiguous numpy arrays of a FIXED shape —
    the final partial batch is padded by wrapping around the shuffled epoch
    (static shapes keep XLA from recompiling);
  * ``device_prefetch`` ships batches to the device mesh one step ahead of
    the train loop (the host->device copy overlaps the previous step's
    compute).

Determinism: worker RNG is derived from (seed, epoch, sample index), so
results are independent of thread scheduling — stronger than the reference's
``worker_init_fn`` (trainer.py:17-18) which seeds each torch worker once.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator

import jax
import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 1234,
        num_workers: int = 8,
        drop_last: bool = False,
        pad_final: bool = True,
        prefetch: int = 4,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """``num_shards``/``shard_index`` give multi-host data sharding: every
        host shuffles the SAME epoch permutation (seed, epoch) and takes a
        disjoint strided slice of it, so the union over hosts is exactly one
        epoch and every host yields the same number of (padded) batches.
        ``batch_size`` is per-host. SURVEY §2.7 ("host data sharding per
        process when multi-host")."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.pad_final = pad_final
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def _shard_len(self) -> int:
        # ceil split, matching _epoch_indices' equalized shards
        n = len(self.dataset)
        return (n + self.num_shards - 1) // self.num_shards

    def __len__(self) -> int:
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        if self.num_shards > 1:
            # Equalize shard sizes first (wrap-pad the permutation), then
            # stride — hosts stay in lockstep on batch count.
            m = self._shard_len() * self.num_shards
            if m > n:
                idx = np.concatenate([idx, idx[: m - n]])
            idx = idx[self.shard_index :: self.num_shards]
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        elif self.pad_final and len(idx) % self.batch_size:
            pad = self.batch_size - len(idx) % self.batch_size
            idx = np.concatenate([idx, idx[:pad]])
        return idx

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        epoch = self.epoch
        self.epoch += 1  # next __iter__ = next epoch, even if partially consumed

        def fetch(i: int):
            rng = np.random.default_rng((self.seed, epoch, int(i)))
            return self.dataset.__getitem__(int(i), rng)

        with ThreadPoolExecutor(self.num_workers) as pool:
            sample_iter = pool.map(fetch, indices)
            batch = []
            for sample in sample_iter:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield _collate(batch)
                    batch = []
            if batch:
                yield _collate(batch)


def _collate(samples: list[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def device_prefetch(iterator, sharding=None, size: int = 2):
    """Move numpy batches to device ahead of time (double-buffered).

    Non-array entries (e.g. case_name lists) pass through on host. When the
    sharding spans multiple processes (a multi-host mesh), each host's local
    batch becomes its addressable shard of one global array
    (``jax.make_array_from_process_local_data``) — the multi-host analogue of
    the single-host sharded ``device_put``.
    """
    queue: Queue = Queue(maxsize=size)
    _sentinel = object()

    multiproc = jax.process_count() > 1 and sharding is not None

    def _put_one(v):
        if sharding is None:
            return jax.device_put(v)
        if multiproc:
            return jax.make_array_from_process_local_data(sharding, v)
        return jax.device_put(v, sharding)

    def _put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                out[k] = _put_one(v)
            else:
                out[k] = v
        return out

    def producer():
        try:
            for batch in iterator:
                queue.put(_put(batch))
            queue.put(_sentinel)
        except BaseException as e:  # propagate into the consumer
            queue.put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = queue.get()
        if item is _sentinel:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
