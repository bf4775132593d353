"""Datasets and the loader (counterpart of `miseg_tpu/data/dataset.py`):
  * `Dataset`: items through the transform on access;
  * `CacheDataset`: the deterministic prefix of the chain (everything
    before the first `Rand*` transform) computed once and kept in RAM
    (`cache_num`, `cache_rate`); the random tail runs on every access;
  * `ConcatDataset`: the modalities' datasets end to end, so a shuffled
    loader interleaves CT and MR;
  * `default_collate`: numpy batches, crops of one item flattened;
  * `DataLoader`: a shuffle keyed `(seed, epoch)`, a generator per item
    keyed `(seed, epoch, index)` handed to the random transforms in
    `data["_rng"]`, `shard`/`num_shards` (DistributedSampler's padding),
    and a bounded thread-pool prefetch of `num_workers` batches.
The keys are the JAX package's, so the same seed gives the same batches.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Any, Callable, Sequence

import numpy as np

from .transforms import Compose, Transform


def _is_random(t: Transform) -> bool:
    return type(t).__name__.startswith("Rand")


class Dataset:
    def __init__(self, data: Sequence[dict], transform: Compose | None = None):
        self.data = list(data)
        self.transform = transform

    def __len__(self):
        return len(self.data)

    def get(self, index: int, rng: np.random.Generator | None = None):
        item = dict(self.data[index])
        if rng is not None:
            item["_rng"] = rng
        if self.transform is not None:
            item = self.transform(item)
        return item

    def __getitem__(self, index: int):
        return self.get(index, np.random.default_rng())


class CacheDataset(Dataset):
    """Caches the deterministic transform prefix in RAM (MONAI CacheDataset)."""

    def __init__(self, data: Sequence[dict], transform: Compose,
                 cache_num: int = 24, cache_rate: float = 1.0,
                 num_workers: int = 4):
        super().__init__(data, transform)
        split = len(transform.transforms)
        for i, t in enumerate(transform.transforms):
            if _is_random(t):
                split = i
                break
        self._prefix = Compose(transform.transforms[:split])
        self._suffix = Compose(transform.transforms[split:])
        n_cache = min(len(self.data), cache_num, int(len(self.data) * cache_rate))
        self._cache: list[Any] = [None] * len(self.data)

        def prep(i):
            return self._prefix(dict(self.data[i]))

        if n_cache > 0:
            with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
                for i, r in zip(range(n_cache), ex.map(prep, range(n_cache))):
                    self._cache[i] = r

    def get(self, index: int, rng: np.random.Generator | None = None):
        item = self._cache[index]
        if item is None:
            item = self._prefix(dict(self.data[index]))
        else:
            item = dict(item)  # shallow copy; suffix must not mutate arrays
        if rng is not None:
            item["_rng"] = rng
        return self._suffix(item)


class ConcatDataset:
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def get(self, index: int, rng=None):
        ds = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[ds].get(index - int(self._offsets[ds]), rng)


def default_collate(items: list[dict], keys=("image", "label", "modality")) -> dict:
    """Stack per-key numpy arrays into a batch dict.

    Items may be lists (RandCropByPosNegLabeld emits num_samples crops per
    volume — flattened here like MONAI's list_data_collate).
    """
    flat: list[dict] = []
    for it in items:
        flat.extend(it if isinstance(it, list) else [it])
    out: dict[str, Any] = {}
    for k in keys:
        if flat and k in flat[0]:
            vals = [np.asarray(d[k]) for d in flat]
            out[k] = np.stack(vals).astype(np.int32) if k == "modality" \
                else np.stack(vals)
    metas = [d.get("image_meta") for d in flat]
    if any(m is not None for m in metas):
        out["image_meta"] = metas
    ops = [d.get("_ops") for d in flat]
    if any(o is not None for o in ops):
        out["_ops"] = ops
    return out


class DataLoader:
    """Deterministic shuffling + host sharding + threaded prefetch."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 num_workers: int = 0, shard: int = 0, num_shards: int = 1,
                 collate_fn: Callable = default_collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.shard = shard
        self.num_shards = num_shards
        self.collate_fn = collate_fn
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        if self.num_shards > 1:
            # pad to a multiple so every shard sees the same step count
            # (DistributedSampler semantics, multi_modal.py:283)
            total = int(np.ceil(n / self.num_shards)) * self.num_shards
            idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.shard::self.num_shards]
        return idx

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return int(np.ceil(n / self.batch_size))

    def __iter__(self):
        idx = self._indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def fetch(batch):
            items = []
            for i in batch:
                rng = np.random.default_rng((self.seed, self.epoch, int(i)))
                items.append(self.dataset.get(int(i), rng))
            return self.collate_fn(items)

        if self.num_workers <= 0:
            for b in batches:
                yield fetch(b)
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            # bounded prefetch: at most `depth` batches in flight or waiting,
            # and none kept once handed out
            depth = max(2, self.num_workers)
            futures = collections.deque(ex.submit(fetch, b) for b in batches[:depth])
            for b in batches[depth:]:
                batch = futures.popleft().result()
                futures.append(ex.submit(fetch, b))
                yield batch
            while futures:
                yield futures.popleft().result()
