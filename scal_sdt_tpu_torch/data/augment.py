"""Config-driven data augmentation on PIL images (port of
``scal_sdt_tpu/data/augment.py``: the same transforms, the same draws in
the same order).

The reference instantiates torchvision transforms by dotted class name
(``reference modules/dataset/augment.py``); here the same config schema
(`augment: [{name, params}, ...]`) resolves against a registry of host-side
PIL/numpy transforms. The torchvision dotted names used in reference configs
are registered as aliases, so configs port unchanged. Augmentation runs on
host CPU before normalization, exactly like the reference (applied after
crop, then resized back to the pre-augment size: datasets.py:108-112).
"""

from __future__ import annotations

import math
import random
from typing import Callable

import numpy as np
from PIL import Image

# Transforms take the image and a per-item random.Random (derived from
# (seed, epoch, item id) by the dataset) so augmentation draws are
# reproducible and thread-safe.
Transform = Callable[[Image.Image, random.Random], Image.Image]

_REGISTRY: dict[str, Callable[..., Transform]] = {}


def register(*names: str):
    def deco(factory):
        for n in names:
            _REGISTRY[n.lower()] = factory
        return factory

    return deco


def max_area_crop_size(w: int, h: int, angle_rad: float) -> tuple[int, int]:
    """Largest axis-aligned rectangle inside a w x h rectangle rotated by
    `angle_rad` (classic geometry result; reference augment.py:13-38)."""
    if w <= 0 or h <= 0:
        return 0, 0
    width_is_longer = w >= h
    side_long, side_short = (w, h) if width_is_longer else (h, w)
    sin_a, cos_a = abs(math.sin(angle_rad)), abs(math.cos(angle_rad))
    if side_short <= 2.0 * sin_a * cos_a * side_long or abs(sin_a - cos_a) < 1e-10:
        x = 0.5 * side_short
        wr, hr = (x / sin_a, x / cos_a) if width_is_longer else (x / cos_a, x / sin_a)
    else:
        cos_2a = cos_a * cos_a - sin_a * sin_a
        wr = (w * cos_a - h * sin_a) / cos_2a
        hr = (h * cos_a - w * sin_a) / cos_2a
    return int(wr), int(hr)


@register("RandomRotationWithCrop", "modules.dataset.augment.RandomRotationWithCrop")
def random_rotation_with_crop(angle_deg: float, interpolation: str = "bilinear") -> Transform:
    assert angle_deg > 0
    interp = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
              "nearest": Image.NEAREST}[str(interpolation).lower()]

    def apply(img: Image.Image, rng: random.Random) -> Image.Image:
        angle = rng.uniform(-angle_deg, angle_deg)
        rotated = img.rotate(angle, resample=interp, expand=True)
        w_c, h_c = max_area_crop_size(img.width, img.height, math.radians(angle))
        left = (rotated.width - w_c) // 2
        top = (rotated.height - h_c) // 2
        return rotated.crop((left, top, left + w_c, top + h_c))

    return apply


@register("RandomHorizontalFlip", "torchvision.transforms.RandomHorizontalFlip")
def random_hflip(p: float = 0.5) -> Transform:
    def apply(img: Image.Image, rng: random.Random) -> Image.Image:
        return img.transpose(Image.FLIP_LEFT_RIGHT) if rng.random() < p else img

    return apply


@register("ColorJitter", "torchvision.transforms.ColorJitter")
def color_jitter(brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0) -> Transform:
    from PIL import ImageEnhance

    def apply(img: Image.Image, rng: random.Random) -> Image.Image:
        if brightness:
            img = ImageEnhance.Brightness(img).enhance(1 + rng.uniform(-brightness, brightness))
        if contrast:
            img = ImageEnhance.Contrast(img).enhance(1 + rng.uniform(-contrast, contrast))
        if saturation:
            img = ImageEnhance.Color(img).enhance(1 + rng.uniform(-saturation, saturation))
        if hue:
            hsv = np.array(img.convert("HSV"), np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(rng.uniform(-hue, hue) * 255)) % 256
            img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
        return img

    return apply


class AugmentTransforms:
    """Chain from the `augment:` config list (reference augment.py:65-75)."""

    def __init__(self, transform_config):
        self.transforms = []
        for item in transform_config:
            name = str(item["name"])
            key = name.lower()
            if key not in _REGISTRY:
                # accept dotted names by terminal class name
                key = name.rsplit(".", 1)[-1].lower()
            if key not in _REGISTRY:
                raise KeyError(f"Unknown augmentation: {name}")
            params = dict(item.get("params", {}) or {})
            self.transforms.append(_REGISTRY[key](**params))

    def __call__(self, img: Image.Image,
                 rng: random.Random | None = None) -> Image.Image:
        rng = rng if rng is not None else random.Random()
        for t in self.transforms:
            img = t(img, rng)
        return img
