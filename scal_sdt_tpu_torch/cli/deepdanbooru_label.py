"""Auto-captioning with DeepDanbooru (port of
``scal_sdt_tpu/cli/deepdanbooru_label.py``; reference: deepdanbooru_label.py).

``python -m scal_sdt_tpu_torch.cli.deepdanbooru_label IMAGE_DIR --model-path
PROJECT [--threshold 0.5] [--alpha-sort] [--no-spaces] [--no-escape]
[--include-ranks] [--overwrite]`` runs the DeepDanbooru tagger over an image
directory and writes per-image ``.txt`` prompt files consumable via the
``{TXT_PROMPT}`` placeholder.

The tagger is a Keras model in the reference and in the JAX package alike,
so it runs here through TensorFlow too, and the AREA resize stays in
TensorFlow so that the captions are the same. A DeepDanbooru project
directory is ``project.json`` (I/O geometry), ``tags.txt`` (one tag per
line), and a Keras model file: the on-disk contract the real
deepdanbooru-v3-20211112-sgd-e28 release ships. Without TensorFlow the tool
raises, naming the package.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

import click
import numpy as np

from ..data.images import list_images, read_image

logger = logging.getLogger("deepdanbooru")

_RE_SPECIAL = re.compile(r"([\\()])")


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("the DeepDanbooru tagger is a Keras model and needs the "
                          "`tensorflow` package, which is not installed") from e
    return tf


def load_tags(model_path: Path) -> list[str]:
    """tags.txt: one tag per line (dd.project.load_tags_from_project)."""
    tags_file = model_path / "tags.txt"
    if not tags_file.exists():
        raise click.UsageError(f"No tags.txt in {model_path}")
    return [t.strip() for t in tags_file.read_text().splitlines() if t.strip()]


def load_model(model_path: Path):
    """Load the project's Keras model + tag list natively via tf.keras.

    Accepts any of the model filenames DeepDanbooru releases have used
    (``model-resnet_custom_v*.h5``, ``*.keras``, a SavedModel dir)."""
    if not (model_path / "project.json").exists():
        raise click.UsageError(
            f"No DeepDanbooru project at {model_path} — download "
            "deepdanbooru-v3-20211112-sgd-e28 and extract it there.")
    tf = _tensorflow()
    candidates = (sorted(model_path.glob("*.h5"))
                  + sorted(model_path.glob("*.keras")))
    if candidates:
        model = tf.keras.models.load_model(str(candidates[0]), compile=False)
    elif (model_path / "saved_model.pb").exists():
        model = tf.keras.models.load_model(str(model_path), compile=False)
    else:
        raise click.UsageError(
            f"No Keras model file (*.h5 / *.keras / SavedModel) in {model_path}")
    return model, load_tags(model_path)


def format_tags(tags, probs, threshold: float, alpha_sort: bool,
                use_spaces: bool, use_escape: bool,
                include_ranks: bool) -> str:
    """Pure tag selection + formatting (reference deepdanbooru_label.py
    semantics: threshold filter, rating:* exclusion, probability or
    alphabetic order, underscore->space, ()\\ escaping, optional
    (tag:prob) ranks). Split from the TF preprocessing so it is testable
    without tensorflow."""
    found = [(tag, float(p)) for tag, p in zip(tags, probs)
             if p >= threshold and not tag.startswith("rating:")]
    found.sort(key=lambda t: t[0] if alpha_sort else -t[1])

    parts = []
    for tag, p in found:
        if use_spaces:
            tag = tag.replace("_", " ")
        if use_escape:
            tag = _RE_SPECIAL.sub(r"\\\1", tag)
        parts.append(f"({tag}:{p:.3f})" if include_ranks else tag)
    return ", ".join(parts)


def _preprocess(pil_image, width: int, height: int) -> np.ndarray:
    """AREA-resample to fit (width, height) preserving aspect, center-pad
    to the canvas, scale to [0,1] — DeepDanbooru's canonical input
    transform (dd.image.transform_and_pad_image with identity warp)."""
    tf = _tensorflow()
    image = np.array(pil_image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    image = tf.image.resize(image[..., :3], size=(height, width),
                            method=tf.image.ResizeMethod.AREA,
                            preserve_aspect_ratio=True).numpy()
    h, w = image.shape[:2]
    canvas = np.zeros((height, width, 3), np.float32)
    y0, x0 = (height - h) // 2, (width - w) // 2
    canvas[y0:y0 + h, x0:x0 + w] = image
    return canvas / 255.0


def tag_image(model, tags, pil_image, threshold: float, alpha_sort: bool,
              use_spaces: bool, use_escape: bool, include_ranks: bool,
              preprocess=None) -> str:
    width, height = model.input_shape[2], model.input_shape[1]
    # late-bound default so tests can monkeypatch module-level _preprocess
    image = (preprocess or _preprocess)(pil_image, width, height)
    probs = np.asarray(model.predict(image[np.newaxis, ...], verbose=0))[0]
    return format_tags(tags, probs, threshold, alpha_sort, use_spaces,
                       use_escape, include_ranks)


@click.command()
@click.argument("image_dir", type=click.Path(exists=True, file_okay=False, path_type=Path))
@click.option("--model-path", type=click.Path(exists=True, file_okay=False, path_type=Path),
              required=True, help="DeepDanbooru project directory (contains project.json).")
@click.option("--threshold", type=float, default=0.5)
@click.option("--alpha-sort", is_flag=True)
@click.option("--no-spaces", is_flag=True, help="Keep underscores in tags.")
@click.option("--no-escape", is_flag=True, help="Do not escape ( ) \\ characters.")
@click.option("--include-ranks", is_flag=True, help="Append (tag:prob) ranks.")
@click.option("--overwrite", is_flag=True, help="Overwrite existing .txt files.")
def main(image_dir: Path, model_path: Path, threshold: float, alpha_sort: bool,
         no_spaces: bool, no_escape: bool, include_ranks: bool, overwrite: bool):
    """Write DeepDanbooru tag captions next to every image in IMAGE_DIR."""
    model, tags = load_model(model_path)
    # sanity: geometry in project.json should match the model (the real
    # v3 project says 448x448; a mismatch means a mixed-up project dir)
    meta = json.loads((model_path / "project.json").read_text())
    pw, ph = meta.get("image_width"), meta.get("image_height")
    if pw and (model.input_shape[2], model.input_shape[1]) != (pw, ph):
        logger.warning(
            f"project.json geometry {pw}x{ph} != model input "
            f"{model.input_shape[2]}x{model.input_shape[1]}; using the model's")
    n = 0
    for path in list_images(image_dir):
        txt = path.with_suffix(".txt")
        if txt.exists() and not overwrite:
            continue
        prompt = tag_image(model, tags, read_image(path), threshold, alpha_sort,
                           not no_spaces, not no_escape, include_ranks)
        txt.write_text(prompt)
        n += 1
    logger.info(f"Labeled {n} images in {image_dir}")


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
