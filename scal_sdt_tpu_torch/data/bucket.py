"""NovelAI-style aspect-ratio bucketing (ARB), port of
``scal_sdt_tpu/data/bucket.py``: the same assignment and batch order.

Re-implements the bucket math and deterministic multi-host sharding of the
reference (``reference modules/dataset/bucket.py``) with identical
observable behaviour:

* bucket-resolution enumeration on a divisor grid bounded by max area and a
  dim range (gen_buckets, bucket.py:60-85);
* min-aspect-error assignment with a skip threshold (put_in, :87-108);
* per-epoch deterministic sharding — shuffle ids with a dedicated PRNG, drop
  the remainder mod (batch * world), stride-slice by rank (:110-124) — which
  per-process sharding with world = the number of training processes;
* weighted batch draws proportional to bucket occupancy with base-res
  leftover batches (:154-207).

The bucket set is finite and known up front: ``BucketManager.resolutions()``
lists every batch shape a run can see.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Hashable, Iterator, Optional

import numpy as np

from . import Size


@dataclass
class Bucket:
    size: Size
    ids: list = field(default_factory=list)

    @property
    def aspect(self) -> float:
        return self.size[0] / self.size[1]

    def __hash__(self):
        return hash(self.size)


def gen_bucket_resolutions(base_res: Size = (512, 512), max_size: int = 768 * 512,
                           dim_range: Size = (256, 1024), divisor: int = 64) -> list[Size]:
    """Enumerate bucket (w, h) resolutions: for each width on the divisor
    grid, the tallest height fitting the area budget (and vice versa)."""
    min_dim, max_dim = dim_range
    resolutions: set[Size] = set()

    w = min_dim
    while w * min_dim <= max_size and w <= max_dim:
        h = min_dim
        while w * (h + divisor) <= max_size and (h + divisor) <= max_dim:
            if (w, h) == tuple(base_res):
                resolutions.add((w, h))
            h += divisor
        resolutions.add((w, h))
        w += divisor

    h = min_dim
    while h / min_dim <= max_size and h <= max_dim:
        w = min_dim
        while h * (w + divisor) <= max_size and (w + divisor) <= max_dim:
            w += divisor
        resolutions.add((w, h))
        h += divisor

    return sorted(resolutions)


def scale_bucket_params(dim: int, c_size: float, c_dim: float, c_div: float) -> dict:
    """Derive bucket-generation params from the training resolution
    (reference modules/dataset/samplers.py:12-18)."""
    return {
        "base_res": (dim, dim),
        "max_size": int(dim ** 2 * c_size),
        "dim_range": (int(dim / c_dim), int(dim * c_dim)),
        "divisor": int(dim / c_div),
    }


def get_gen_bucket_params(dim: int, bucket_config) -> dict:
    params = scale_bucket_params(
        dim, bucket_config.c_size, bucket_config.c_dim, bucket_config.c_div)
    manual = bucket_config.get("manual")
    if manual is not None:
        params.update({k: tuple(v) if isinstance(v, list) else v for k, v in manual.items()})
    return params


class BucketManager:
    """Assigns dataset ids to buckets and yields (ids, resolution) batches."""

    def __init__(self, batch_size: int, seed: Optional[int] = None,
                 world_size: int = 1, global_rank: int = 0):
        self.batch_size = batch_size
        self.world_size = world_size
        self.global_rank = global_rank

        self.buckets: list[Bucket] = []
        self.id_size_map: dict[Hashable, Size] = {}
        self.base_res: Optional[Size] = None
        self._epoch: Optional[dict[Bucket, list]] = None
        self._leftovers: Optional[list] = None
        self.batch_total = 0
        self.batch_delivered = 0

        # Epoch-indexed PRNGs: every epoch's shuffle/draw sequence is a pure
        # function of (seed, epoch), so (a) all processes agree without
        # communication (the reference's identical-seed guarantee,
        # bucket.py:47-50) and (b) a mid-epoch resume can replay epoch E
        # exactly without fast-forwarding through epochs 0..E-1.
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 31 - 1))
        self.seed = int(seed)
        self.epoch = -1
        self.bucket_prng = np.random.RandomState(self.seed)
        # Separate sharding PRNG so bucket draws and rank sharding cannot
        # desync across processes (reseeded per epoch in start_epoch).
        self.sharding_prng = np.random.RandomState(self.seed)

    # -- setup --------------------------------------------------------------

    def gen_buckets(self, base_res: Size = (512, 512), max_size: int = 768 * 512,
                    dim_range: Size = (256, 1024), divisor: int = 64):
        self.base_res = tuple(base_res)
        self.buckets = [Bucket(size) for size in
                        gen_bucket_resolutions(tuple(base_res), max_size, tuple(dim_range), divisor)]

    def resolutions(self, nonempty_only: bool = False) -> list[Size]:
        """All sizes a batch may take (every batch shape of a run).

        ``nonempty_only`` (after ``put_in``): only buckets that actually
        hold images, plus the base resolution (leftover batches always run
        at base res); empty buckets can never produce a batch."""
        buckets = self.buckets
        if nonempty_only:
            buckets = [b for b in buckets if b.ids]
        sizes = [b.size for b in buckets]
        if self.base_res and self.base_res not in sizes:
            sizes.append(self.base_res)
        return sizes

    def put_in(self, id_size_map: dict[Hashable, Size], max_aspect_error: float = 0.5):
        """Assign each id to the bucket with minimal |aspect error|; ids whose
        best error exceeds the threshold are skipped entirely."""
        self.id_size_map = dict(id_size_map)
        skipped = []
        for id_, (w, h) in id_size_map.items():
            aspect = w / h
            best = min(self.buckets, key=lambda b: abs(b.aspect - aspect))
            if abs(best.aspect - aspect) < max_aspect_error:
                best.ids.append(id_)
            else:
                skipped.append(id_)
        return skipped

    # -- epoch machinery ----------------------------------------------------

    def _local_ids(self) -> set:
        """Deterministic per-rank shard of the epoch's ids."""
        ids = list(self.id_size_map.keys())
        self.sharding_prng.shuffle(ids)
        usable = len(ids) - len(ids) % (self.batch_size * self.world_size)
        ids = ids[:usable][self.global_rank::self.world_size]
        assert len(ids) % self.batch_size == 0
        self.batch_total = len(ids) // self.batch_size
        return set(ids)

    def start_epoch(self, epoch: Optional[int] = None):
        """Start epoch `epoch` (default: the one after the last started).
        Reseeds both PRNGs from (seed, epoch) — see __init__."""
        from .datasets import mix_seed

        self.epoch = self.epoch + 1 if epoch is None else int(epoch)
        self.bucket_prng = np.random.RandomState(
            mix_seed(self.seed, self.epoch, 1) % (2 ** 31 - 1))
        self.sharding_prng = np.random.RandomState(
            mix_seed(self.seed, self.epoch, 2) % (2 ** 31 - 1))
        local = self._local_ids()
        epoch: dict[Bucket, list] = {}
        leftovers: list = []
        for bucket in self.buckets:
            chosen = [i for i in bucket.ids if i in local]
            self.bucket_prng.shuffle(chosen)
            rem = len(chosen) % self.batch_size
            if rem:
                leftovers.extend(chosen[:rem])
                chosen = chosen[rem:]
            if chosen:
                epoch[bucket] = chosen
        self._epoch = epoch
        self._leftovers = leftovers
        self.batch_delivered = 0

    @property
    def epoch_null(self) -> bool:
        return self._epoch is None or self._leftovers is None

    @property
    def epoch_empty(self) -> bool:
        return (not (self._leftovers or self._epoch)
                or self.batch_total == self.batch_delivered)

    def get_batch(self) -> tuple[list, Size]:
        """Draw one batch: a bucket chosen with probability proportional to
        its remaining ids, or a base-res batch from the leftover pool."""
        if self.epoch_null:
            raise RuntimeError("start_epoch() not called")
        assert self._epoch is not None and self._leftovers is not None

        while True:
            choices: list = list(self._epoch.keys())
            weights = [len(self._epoch[b]) for b in choices]
            if len(self._leftovers) >= self.batch_size:
                choices.append(None)  # leftover pool
                weights.append(len(self._leftovers))

            probs = np.asarray(weights, np.float64)
            probs /= probs.sum()
            idx = self.bucket_prng.choice(len(choices), p=probs) if self._epoch else len(choices) - 1
            chosen = choices[idx]

            if chosen is None:
                self.bucket_prng.shuffle(self._leftovers)
                batch = self._leftovers[: self.batch_size]
                self._leftovers = self._leftovers[self.batch_size:]
                self.batch_delivered += 1
                return batch, self.base_res

            ids = self._epoch[chosen]
            if len(ids) >= self.batch_size:
                batch, self._epoch[chosen] = ids[: self.batch_size], ids[self.batch_size:]
                if not self._epoch[chosen]:
                    del self._epoch[chosen]
                self.batch_delivered += 1
                return batch, chosen.size

            # Not enough for a whole batch: demote to leftovers and redraw.
            self._leftovers.extend(ids)
            del self._epoch[chosen]

    def generator(self) -> Iterator[tuple[list, Size]]:
        if self.epoch_null or self.epoch_empty:
            self.start_epoch()
        while not self.epoch_empty:
            yield self.get_batch()
