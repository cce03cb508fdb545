"""Index samplers: fixed-size and aspect-ratio-bucketed, with DreamBooth
variants (port of ``scal_sdt_tpu/data/samplers.py``; reference:
modules/dataset/samplers.py).

Samplers yield ``Index(value, size)`` (or pairs for DreamBooth). Consecutive
``batch_size`` indices always share one size, so each collated batch has one
static shape.
"""

from __future__ import annotations

import copy
import random
from typing import Iterator

from . import Size
from .bucket import BucketManager, get_gen_bucket_params
from .datasets import AspectDataset, DBDataset, ImagePromptDataset, Index, mix_seed


class ConstantSizeSampler:
    """Fixed-size sampler. Multi-host sharding is built in (the reference
    delegates it to Lightning's DistributedSampler injection; here each
    process strides the index space)."""

    def __init__(self, data_source: ImagePromptDataset, size: int,
                 world_size: int = 1, global_rank: int = 0, seed=None):
        self._indices = range(global_rank, len(data_source), world_size)
        self.size = size
        self.epoch = 0  # draw-free sampler; attr kept for pipeline uniformity

    def __iter__(self) -> Iterator[Index]:
        s = (self.size, self.size)
        for i in self._indices:
            yield Index(i, s)

    def __len__(self) -> int:
        return len(self._indices)


class ConstantSizeSamplerDB:
    def __init__(self, data_source: DBDataset, size: int,
                 world_size: int = 1, global_rank: int = 0, seed=None):
        self._indices = range(global_rank, len(data_source.instance_set), world_size)
        self._class_len = len(data_source.class_set)
        self.size = size
        self.seed = int(seed or 0)
        self.epoch = 0

    def __iter__(self):
        # Class pairings are a pure function of (seed, epoch): reproducible
        # across runs and replayable on mid-epoch resume.
        rng = random.Random(mix_seed(self.seed, self.epoch, 0xDB))
        s = (self.size, self.size)
        for i in self._indices:
            yield Index(i, s), Index(rng.randint(0, self._class_len - 1), s)

    def __len__(self) -> int:
        return len(self._indices)


class AspectSampler:
    def __init__(self, data_source: AspectDataset, base_size: int, bucket_config,
                 batch_size: int, seed, world_size: int = 1, global_rank: int = 0):
        manager = BucketManager(batch_size, seed, world_size, global_rank)
        manager.gen_buckets(**get_gen_bucket_params(base_size, bucket_config))
        self.skipped = manager.put_in(data_source.id_size_map, bucket_config.max_aspect_error)
        self.bucket_manager = manager
        self._batch_size = batch_size
        self.epoch: int | None = None  # None -> auto-increment per pass

    def __iter__(self) -> Iterator[Index]:
        self.bucket_manager.start_epoch(self.epoch)
        while not self.bucket_manager.epoch_empty:
            batch, size = self.bucket_manager.get_batch()
            yield from (Index(i, size) for i in batch)

    def __len__(self) -> int:
        if self.bucket_manager.epoch_null:
            self.bucket_manager.start_epoch(self.epoch)
        return self.bucket_manager.batch_total * self._batch_size


class AspectSamplerDB:
    """ARB + DreamBooth: class items are bucketed with the same bucket set and
    matched to the instance batch's resolution (samplers.py:107-170)."""

    def __init__(self, data_source: DBDataset, base_size: int, bucket_config,
                 batch_size: int, seed, world_size: int = 1, global_rank: int = 0):
        manager = BucketManager(batch_size, seed, world_size, global_rank)
        manager.gen_buckets(**get_gen_bucket_params(base_size, bucket_config))
        pristine_buckets = copy.deepcopy(manager.buckets)
        manager.put_in(data_source.instance_set.id_size_map, bucket_config.max_aspect_error)
        self.bucket_manager = manager
        self._batch_size = batch_size

        class_manager = BucketManager(1, seed, world_size, global_rank)
        class_manager.buckets = pristine_buckets
        class_manager.base_res = manager.base_res
        class_manager.put_in(data_source.class_set.id_size_map, bucket_config.max_aspect_error)

        self.class_bucket_id_map: dict[Size, list[int]] = {}
        for batch, size in class_manager.generator():
            self.class_bucket_id_map.setdefault(size, []).append(batch[0])

        self._seed = int(seed or 0)
        self.epoch: int | None = None  # None -> auto-increment per pass

    def _closest_class_ids(self, size: Size) -> list[int]:
        target = size[0] / size[1]
        closest = min(self.class_bucket_id_map,
                      key=lambda s: abs(s[0] / s[1] - target))
        return self.class_bucket_id_map[closest]

    def __iter__(self):
        self.bucket_manager.start_epoch(self.epoch)
        rng = random.Random(mix_seed(self._seed, self.bucket_manager.epoch, 0xDB))
        while not self.bucket_manager.epoch_empty:
            batch, size = self.bucket_manager.get_batch()
            for instance_id in batch:
                class_ids = self.class_bucket_id_map.get(size) or self._closest_class_ids(size)
                yield Index(instance_id, size), Index(rng.choice(class_ids), size)

    def __len__(self) -> int:
        if self.bucket_manager.epoch_null:
            self.bucket_manager.start_epoch(self.epoch)
        return self.bucket_manager.batch_total * self._batch_size
