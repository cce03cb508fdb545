"""Datasets: image+prompt concepts, ARB variant, DreamBooth pairing, cache.

Port of ``scal_sdt_tpu/data/datasets.py`` (host-side analogue of the
reference's modules/dataset/datasets.py): numpy HWC outputs, bit for bit
those of the JAX package for the same seed; the port's device upload
(``data/pipeline.py`` ``to_device``) makes them NCHW. Semantics preserved:

* concepts are (image dir, prompt) pairs; a ``{TXT_PROMPT}`` placeholder (or
  a null prompt) pulls per-image ``.txt`` captions (datasets.py:93-106);
* fixed-res path: resize shortest side to ``dim`` with LANCZOS, then
  center/random crop, normalize to [-1, 1] (:114-127);
* ARB path: resize preserving aspect ratio so the image covers the bucket,
  then crop to the bucket size (:154-208);
* cache-backed items return precomputed latents (one of ``aug_group_size``
  variants chosen uniformly) and conditions (:83-88);
* DreamBooth zips an instance item with a class item (:211-225).

Images decode through the native decoder (``native/image.py``, the port's
build of the JAX package's ``native/ssdt_image.cpp``) wherever the JAX
package's ``_native_transform`` uses it: no augmentation configured, the
same crop fractions from the same ``rng`` draws, and ``size_cond``
recomputed from the header with the same cover-resize rule; otherwise, or
when the decoder cannot be built, through PIL.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
from PIL import Image

from . import Size
from .augment import AugmentTransforms
from .images import get_id_size_map, list_images, read_image

PLACEHOLDER_TXT_PROMPT = "{TXT_PROMPT}"


def mix_seed(*parts: int) -> int:
    """Deterministic 63-bit hash of integer parts (FNV-style). Used to derive
    per-(seed, epoch, item) RNGs so data randomness (crops, augments, cache
    group picks, DreamBooth pairings) is reproducible across runs and across
    pipeline threads — the role pl.seed_everything plays in the reference
    (reference train.py:118-119), which global-`random` draws from
    worker threads cannot provide."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (int(p) & 0x7FFFFFFFFFFFFFFF)) * 0x100000001B3) % (1 << 63)
    return h


@dataclass
class Concept:
    path: Path
    prompt: Optional[str]


@dataclass
class Item:
    id: int
    prompt: str
    image: np.ndarray  # (H, W, 3) float32 in [-1, 1]
    # (orig_h, orig_w, crop_top, crop_left) — SDXL size micro-conditioning
    # (original file size; crop offsets in resized space, diffusers
    # SDXL-trainer semantics). None when unknown.
    size_cond: Optional[tuple[int, int, int, int]] = None


@dataclass
class CacheItem:
    id: int
    latent: np.ndarray     # (h, w, 4) float32, already scaled
    condition: Optional[np.ndarray]  # (L, D) float32 or None
    pooled: Optional[np.ndarray] = None  # (D2,) SDXL pooled embed or None


ItemType = Union[Item, CacheItem]


@dataclass(frozen=True)
class Index:
    value: int
    size: Size


def _to_array(img: Image.Image) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return arr * 2.0 - 1.0


class LatentCache:
    """Reader for the offline latent/cond cache (built by ``cache.py``).

    File format matches the reference byte-for-byte: one safetensors file
    with keys ``{id}.latent.{g}`` / ``{id}.cond`` and a JSON metadata blob
    {sizes, entries, total_entries, aug_group_size} (cache.py:129-154).
    Latents are stored (h, w, 4) HWC. Tensors come back as numpy arrays;
    bf16 entries (a cache encoded with bf16 weights) widen exactly to fp32,
    since numpy has no bf16 of its own.
    """

    def __init__(self, path: Union[str, Path]):
        from safetensors import safe_open

        self._f = safe_open(str(path), framework="pt")
        self._keys = set(self._f.keys())
        self.metadata = json.loads(self._f.metadata()["json"])

    def _get(self, key: str) -> np.ndarray:
        t = self._f.get_tensor(key)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    @property
    def aug_group_size(self) -> int:
        return int(self.metadata["aug_group_size"])

    @property
    def total_entries(self) -> int:
        return int(self.metadata["total_entries"])

    @property
    def entries(self) -> list:
        return self.metadata["entries"]

    def latent(self, id_: int, group: int) -> np.ndarray:
        return self._get(f"{id_}.latent.{group}")

    def cond(self, id_: int) -> Optional[np.ndarray]:
        key = f"{id_}.cond"
        return self._get(key) if key in self._keys else None

    def pooled(self, id_: int) -> Optional[np.ndarray]:
        """SDXL pooled projected embedding (``{id}.pooled``), if cached."""
        key = f"{id_}.pooled"
        return self._get(key) if key in self._keys else None

    def latent_size(self, id_: int) -> Size:
        h, w = self.metadata["sizes"][f"{id_}.latent.0"][:2]
        # stored as latent shape; image-space size is x8 with (w, h) order
        return (int(w) * 8, int(h) * 8)


class ImagePromptDataset:
    """Fixed-resolution dataset; index carries the target size."""

    def __init__(self, concepts: list[Concept], center_crop: bool = False,
                 augment_config=None, cache_file: Optional[Union[str, Path]] = None,
                 seed: int = 0, caption_config=None):
        self.dir_prompt_map = {Path(c.path): c.prompt for c in concepts}
        self.image_paths = list(list_images(*self.dir_prompt_map.keys()))
        self.center_crop = center_crop
        self.augment = AugmentTransforms(augment_config) if augment_config else None
        self.cache = LatentCache(cache_file) if cache_file is not None else None
        self.caption = dict(caption_config or {})
        self.seed = int(seed)
        # epoch is set by the pipeline each pass so per-item draws vary across
        # epochs but replay exactly on resume (mid-epoch resume fidelity)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.image_paths) if self.cache is None else self.cache.total_entries

    def _item_rng(self, index: Index) -> random.Random:
        return random.Random(mix_seed(self.seed, self.epoch, index.value))

    def __getitem__(self, index: Index) -> ItemType:
        rng = self._item_rng(index)
        if self.cache is not None:
            group = rng.randint(0, self.cache.aug_group_size - 1)
            return CacheItem(
                id=index.value,
                latent=self.cache.latent(index.value, group),
                condition=self.cache.cond(index.value),
                pooled=self.cache.pooled(index.value),
            )
        path = self.image_paths[index.value]
        image, size_cond = self._read_and_transform(path, index.size, rng)
        return Item(
            id=index.value,
            image=image,
            prompt=self._transform_caption(self.get_prompt(path), rng),
            size_cond=size_cond,
        )

    def _transform_caption(self, prompt: str, rng: random.Random) -> str:
        """kohya-style caption regularization (``data.caption:`` config,
        beyond reference parity). Deterministic per (seed, epoch, item) so
        resume replays the same draws. Applies only on the image path —
        cached conds are precomputed before any caption transform.

        dropout:     prob. the whole caption becomes "" (trains the uncond)
        tag_shuffle: shuffle the comma-separated tag list
        tag_dropout: per-tag drop probability
        keep_tokens: first N tags exempt from shuffle/dropout
        """
        cc = self.caption
        if not cc:
            return prompt
        # draw nothing when a knob is off: the per-item rng is shared with
        # crop/augment draws, and an unused draw would shift those
        dropout = float(cc.get("dropout", 0.0))
        if dropout > 0.0 and rng.random() < dropout:
            return ""
        shuffle = bool(cc.get("tag_shuffle", False))
        tag_dropout = float(cc.get("tag_dropout", 0.0))
        if not shuffle and tag_dropout <= 0.0:
            return prompt
        tags = [t.strip() for t in prompt.split(",")]
        keep = int(cc.get("keep_tokens", 0))
        head, tail = tags[:keep], tags[keep:]
        if tag_dropout > 0.0:
            tail = [t for t in tail if rng.random() >= tag_dropout]
        if shuffle:
            rng.shuffle(tail)
        return ", ".join(head + tail)

    def get_prompt(self, path: Path) -> str:
        prompt = self.dir_prompt_map[path.parent]
        if prompt is None:
            prompt = PLACEHOLDER_TXT_PROMPT
        elif PLACEHOLDER_TXT_PROMPT not in prompt:
            return prompt
        txt_path = path.with_suffix(".txt")
        if not txt_path.is_file():
            raise FileNotFoundError(f'Image "{path}" has no corresponding prompt txt')
        return prompt.replace(PLACEHOLDER_TXT_PROMPT, txt_path.read_text())

    def _crop(self, img: Image.Image, cw: int, ch: int,
              rng: random.Random) -> tuple[Image.Image, int, int]:
        """Crop to (cw, ch); returns (img, top, left) so the offsets can
        feed SDXL size micro-conditioning."""
        if self.center_crop:
            left = (img.width - cw) // 2
            top = (img.height - ch) // 2
        else:
            left = rng.randint(0, max(img.width - cw, 0))
            top = rng.randint(0, max(img.height - ch, 0))
        return img.crop((left, top, left + cw, top + ch)), top, left

    def _maybe_augment(self, img: Image.Image, rng: random.Random) -> Image.Image:
        if self.augment is None:
            return img
        w, h = img.size
        img = self.augment(img, rng)
        if img.size != (w, h):
            img = img.resize((w, h), Image.BICUBIC)
        return img

    def _crop_fracs(self, rng: random.Random) -> tuple[float, float]:
        if self.center_crop:
            return 0.5, 0.5
        return rng.random(), rng.random()

    def _native_transform(self, path: Path, cw: int, ch: int, rng: random.Random):
        """Decode, resize, crop and normalize in one native call (the GIL
        released) when the decoder is built and no augmentation is
        configured; None sends the item to PIL."""
        if self.augment is not None:
            return None
        from ..native import image as native_image

        if not native_image.available():
            return None
        fx, fy = self._crop_fracs(rng)
        arr = native_image.decode_resize_crop(path, cw, ch, fx, fy)
        if arr is None:
            return None
        # size conditioning: the original size from the header, the crop
        # offsets by the cover-resize rule of the native pipeline
        with Image.open(path) as im:
            ow, oh = im.size
        scale = max(cw / ow, ch / oh)
        rw = max(round(ow * scale), cw)
        rh = max(round(oh * scale), ch)
        top = int(fy * max(rh - ch, 0))
        left = int(fx * max(rw - cw, 0))
        return arr, (oh, ow, top, left)

    def _read_and_transform(self, path: Path, size: Size, rng: random.Random
                            ) -> tuple[np.ndarray, tuple[int, int, int, int]]:
        dim = size[0]
        native = self._native_transform(path, dim, dim, rng)
        if native is not None:
            return native
        img = read_image(path)
        ow, oh = img.size
        # resize shortest side to dim (torchvision Resize(dim) semantics)
        scale = dim / min(img.size)
        img = img.resize((max(round(img.width * scale), dim),
                          max(round(img.height * scale), dim)), Image.LANCZOS)
        img, top, left = self._crop(img, dim, dim, rng)
        img = self._maybe_augment(img, rng)
        return _to_array(img), (oh, ow, top, left)


class AspectDataset(ImagePromptDataset):
    """ARB dataset: items are resized preserving aspect ratio to cover the
    assigned bucket, then cropped to the bucket resolution."""

    def __init__(self, *args, debug: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.debug = debug
        if self.cache is None:
            self.id_size_map = get_id_size_map(self.image_paths)
        else:
            self.id_size_map = {int(k): self.cache.latent_size(k) for k in self.cache.entries}

    @staticmethod
    def preserve_ratio_size(size: Size, dsize: Size) -> Size:
        """Smallest resize of `size` that covers `dsize` at original aspect
        (reference datasets.py:192-208)."""
        w, h = size
        w_d, h_d = dsize
        scale = max(w_d / w, h_d / h)
        return (max(int(round(w * scale)), w_d), max(int(round(h * scale)), h_d))

    def _read_and_transform(self, path: Path, size: Size, rng: random.Random
                            ) -> tuple[np.ndarray, tuple[int, int, int, int]]:
        if not self.debug:
            native = self._native_transform(path, size[0], size[1], rng)
            if native is not None:
                return native
        img = read_image(path)
        ow, oh = img.size
        w_t, h_t = self.preserve_ratio_size(img.size, size)
        img = img.resize((w_t, h_t), Image.LANCZOS)
        img, top, left = self._crop(img, size[0], size[1], rng)
        img = self._maybe_augment(img, rng)
        if self.debug:
            print(f"arb: {path.name} -> resize ({w_t},{h_t}) crop {size}")
        return _to_array(img), (oh, ow, top, left)


class DBDataset:
    """DreamBooth pairing: instance item + class item per index."""

    def __init__(self, instance_set: ImagePromptDataset, class_set: ImagePromptDataset):
        self.instance_set = instance_set
        self.class_set = class_set

    @property
    def epoch(self) -> int:
        return self.instance_set.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self.instance_set.epoch = value
        self.class_set.epoch = value

    def __len__(self) -> int:
        return len(self.instance_set)

    def __getitem__(self, index: tuple[Index, Index]) -> tuple[ItemType, ItemType]:
        return self.instance_set[index[0]], self.class_set[index[1]]
