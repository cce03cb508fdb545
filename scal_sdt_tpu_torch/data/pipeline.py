"""Input pipeline: dataset/sampler construction, collation, prefetch, and
the upload of a batch to the device (port of ``scal_sdt_tpu/data/pipeline.py``).

Replaces the reference's torch DataLoader + sampler stack (its
modules/dataset/__init__.py and modules/model.py:350-364) with a host-side
thread pipeline: the sampler yields fixed-shape index batches, a worker pool
decodes/resizes images (PIL releases the GIL for the hot parts), and a
bounded queue prefetches batches ahead of the device step so host IO
overlaps device compute. The numpy batches are those of the JAX package
(NHWC images, HWC latents); ``to_device`` alone moves them to the port's
NCHW layout. An SD3 model with T5 tokenizes the same prompts a second time
with ``tokenizer_3`` (``t5_ids``, and the empty prompt's ``t5_uncond_ids``).

Collate semantics mirror the reference exactly (``collate_fn``,
modules/dataset/__init__.py:54-98): DreamBooth class items are appended
AFTER the instance items along batch (the train step splits the batch in
half for the prior loss), and cache-backed items produce
``{latents, conds}`` instead of ``{images, input_ids}``.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..conf import Config
from ..device import resolve_device
from .datasets import (
    AspectDataset,
    CacheItem,
    Concept,
    DBDataset,
    ImagePromptDataset,
    Item,
    ItemType,
)
from .samplers import (
    AspectSampler,
    AspectSamplerDB,
    ConstantSizeSampler,
    ConstantSizeSamplerDB,
)


def get_dataset(config: Config, use_cache: bool = True):
    """Reference modules/dataset/__init__.py:14-33."""
    arb = config.aspect_ratio_bucket.get("enabled", False)
    dataset_type = AspectDataset if arb else ImagePromptDataset
    params = {
        "center_crop": config.data.get("center_crop", False),
        "augment_config": config.get("augment"),
        "cache_file": config.data.get("cache") if use_cache else None,
        "seed": int(config.get("seed") or 0),
        "caption_config": config.data.get("caption"),
    }
    if arb and config.aspect_ratio_bucket.get("debug"):
        params["debug"] = True

    instance_set = dataset_type(
        [Concept(c.instance_set.path, c.instance_set.get("prompt"))
         for c in config.data.concepts], **params)

    if not config.prior_preservation.get("enabled", False):
        return instance_set

    class_set = dataset_type(
        [Concept(c.class_set.path, c.class_set.get("prompt"))
         for c in config.data.concepts], **params)
    return DBDataset(instance_set, class_set)


def get_sampler(dataset, config: Config, world_size: int, global_rank: int):
    """Reference modules/dataset/__init__.py:36-51."""
    prior = config.prior_preservation.get("enabled", False)
    if not config.aspect_ratio_bucket.get("enabled", False):
        sampler_type = ConstantSizeSamplerDB if prior else ConstantSizeSampler
        return sampler_type(dataset, config.data.resolution, world_size,
                            global_rank, seed=config.get("seed"))
    sampler_type = AspectSamplerDB if prior else AspectSampler
    return sampler_type(
        data_source=dataset,
        base_size=config.data.resolution,
        bucket_config=config.aspect_ratio_bucket,
        batch_size=config.batch_size,
        seed=config.get("seed"),
        world_size=world_size,
        global_rank=global_rank,
    )


def collate(items: list) -> dict:
    """list of Item/CacheItem (or DreamBooth pairs) -> numpy batch dict."""
    instance: list[ItemType] = []
    class_items: list[ItemType] = []
    for x in items:
        if isinstance(x, tuple):
            instance.append(x[0])
            class_items.append(x[1])
        else:
            instance.append(x)
    ordered = instance + class_items

    batch: dict = {"ids": [it.id for it in ordered]}
    if isinstance(ordered[0], CacheItem):
        batch["latents"] = np.stack([it.latent for it in ordered])
        if ordered[0].condition is not None:
            batch["conds"] = np.stack([it.condition for it in ordered])
            if ordered[0].pooled is not None:   # SDXL cache
                batch["pooled"] = np.stack([it.pooled for it in ordered])
        else:
            batch["prompts"] = None  # caller must tokenize separately
    else:
        batch["images"] = np.stack([it.image for it in ordered])
        batch["prompts"] = [it.prompt for it in ordered]
        if all(it.size_cond is not None for it in ordered):
            # (B, 4) int32 [orig_h, orig_w, crop_top, crop_left] — SDXL size
            # micro-conditioning; SD1.x/2.x steps ignore it
            batch["size_cond"] = np.asarray(
                [it.size_cond for it in ordered], np.int32)
    return batch


class DataPipeline:
    """Iterable over device-ready batches for one epoch pass.

    `tokenizer` converts prompts to `input_ids`; `uncond_ids` (the empty
    prompt) is attached once per batch for CFG-dropout's 'eos' mode.
    `tokenizer_3` (SD3's T5) adds `t5_ids` and `t5_uncond_ids` likewise.
    `rows` ([lo, hi)): a rank of a multi-process run decodes only these rows
    of each host batch (DreamBooth pairs whole: its class items follow).
    """

    def __init__(self, dataset, sampler, batch_size: int, tokenizer=None,
                 num_workers: int = 2, prefetch: int = 2, tokenizer_3=None,
                 rows: tuple[int, int] | None = None):
        self.dataset = dataset
        self.rows = rows
        self.sampler = sampler
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.tokenizer_3 = tokenizer_3
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self._uncond_ids = self._t5_uncond_ids = None
        if tokenizer is not None:
            self._uncond_ids = tokenizer([""])
        if tokenizer_3 is not None:
            self._t5_uncond_ids = tokenizer_3([""])
        self._epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Pin the epoch index the next ``__iter__`` pass will use (and
        optionally fast-forward `skip_batches` index batches without decoding
        them) — the mid-epoch resume hook. Without a call, passes
        auto-increment from 0 (torch DistributedSampler.set_epoch analogue)."""
        self._epoch = int(epoch)
        self._skip_batches = int(skip_batches)

    def _apply_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = epoch
        if hasattr(self.sampler, "epoch"):
            self.sampler.epoch = epoch

    def __len__(self) -> int:
        return len(self.sampler) // self.batch_size

    def _load_batch(self, indices: list) -> dict:
        if self.rows is not None:
            indices = indices[self.rows[0]:self.rows[1]]
        items = [self.dataset[i] for i in indices]
        batch = collate(items)
        prompts = batch.pop("prompts", None)
        if prompts is not None and self.tokenizer is not None:
            batch["input_ids"] = self.tokenizer(prompts)
            batch["uncond_ids"] = self._uncond_ids
            if self.tokenizer_3 is not None:
                batch["t5_ids"] = self.tokenizer_3(prompts)
                batch["t5_uncond_ids"] = self._t5_uncond_ids
        return batch

    def _index_batches(self) -> Iterator[list]:
        it = iter(self.sampler)
        while True:
            chunk = list(itertools.islice(it, self.batch_size))
            if len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self) -> Iterator[dict]:
        self._apply_epoch(self._epoch)
        skip = self._skip_batches
        self._skip_batches = 0
        self._epoch += 1  # next pass defaults to the following epoch

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when the consumer abandoned us
            (early break out of the epoch, e.g. max_steps reached)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # Windowed submission: at most workers+prefetch decoded batches in
            # flight, so memory stays bounded however slow the consumer is.
            try:
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                window = self.num_workers + self.prefetch
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending: deque = deque()
                    batches = self._index_batches()
                    for _ in range(skip):  # mid-epoch resume: indices only
                        next(batches, None)
                    for idx_batch in itertools.islice(batches, window):
                        pending.append(pool.submit(self._load_batch, idx_batch))
                    while pending:
                        if not put(pending.popleft().result()):
                            return
                        nxt = next(batches, None)
                        if nxt is not None:
                            pending.append(pool.submit(self._load_batch, nxt))
            except BaseException as e:  # propagate to consumer
                put(e)
                return
            put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


# numpy batch entries laid out channels-last: (B, H, W, C) images, (B, h, w, C)
# cached latents
_CHANNELS_LAST = ("images", "latents")


def to_device(batch: dict, device="cuda") -> dict:
    """A numpy batch of ``DataPipeline`` -> tensors on ``device``: images
    (B, H, W, 3) -> (B, 3, H, W), latents (B, h, w, 4) -> (B, 4, h, w), the
    other arrays as they are (int32 ids stay int32); entries that are not
    arrays (``ids``) pass through. On CUDA each array is copied from pinned
    memory without blocking the host, then made NCHW on the device."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory()
        t = t.to(dev, non_blocking=True)
        if k in _CHANNELS_LAST:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out
