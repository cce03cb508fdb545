"""Image file IO (port of ``scal_sdt_tpu/data/images.py``; reference:
modules/utils/io/image.py)."""

from __future__ import annotations

from itertools import chain
from pathlib import Path
from typing import Iterable

from PIL import Image

SUPPORTED_EXTENSIONS = {
    ".jpe", ".jpg", ".jpeg", ".gif", ".apng", ".jfif",
    ".tif", ".tiff", ".bmp", ".png", ".webp",
}


def is_image_file(path: Path) -> bool:
    return path.is_file() and path.suffix.lower() in SUPPORTED_EXTENSIONS


def list_images(*dirs: Path) -> Iterable[Path]:
    return chain(*(
        (p for p in sorted(Path(d).iterdir()) if is_image_file(p))
        for d in dirs
    ))


def read_image(path: Path) -> Image.Image:
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return img


def get_id_size_map(image_paths: Iterable[Path]) -> dict[int, tuple[int, int]]:
    """id -> (w, h) without decoding pixel data (PIL reads headers lazily)."""
    id_size_map = {}
    for i, path in enumerate(image_paths):
        with Image.open(path) as img:
            id_size_map[i] = img.size
    return id_size_map
