"""DreamBooth class-image generation (port of
``scal_sdt_tpu/cli/gen_class_imgs.py``; reference: gen_class_imgs.py).

    python -m scal_sdt_tpu_torch.cli.gen_class_imgs --config cfg.yaml [--device cuda]

For each concept whose ``class_set.auto_generate`` is enabled: compute the
target size distribution (square, or the instance set's ARB bucket
distribution), take away what the class folder already holds, and sample
the shortfall with the port's samplers, saving each image under the MD5 of
its pixels. A second run over a complete folder generates nothing. Each
batch draws from a generator seeded from ``(config.seed, batch counter)``,
the analogue of the JAX CLI's ``fold_in(PRNGKey(seed), counter)``.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path
from typing import IO

import click
import numpy as np
import torch

from ..conf import load_with_defaults
from ..data import Size
from ..data.bucket import BucketManager, get_gen_bucket_params
from ..data.images import get_id_size_map, list_images
from ..device import resolve_device

logger = logging.getLogger("cls-gen")


def get_size_dist(image_dir: Path) -> dict[Size, float]:
    paths = list(list_images(image_dir))
    if not paths:
        return {}
    dist: dict[Size, float] = {}
    for s in get_id_size_map(paths).values():
        dist[s] = dist.get(s, 0) + 1
    return {k: v / len(paths) for k, v in dist.items()}


def get_arb_size_dist(image_dir: Path, resolution: int, arb_config) -> dict[Size, float]:
    paths = list(list_images(image_dir))
    manager = BucketManager(1)
    manager.gen_buckets(**get_gen_bucket_params(resolution, arb_config))
    manager.put_in(get_id_size_map(paths), arb_config.max_aspect_error)
    return {b.size: len(b.ids) / len(paths) for b in manager.buckets}


def get_delta_dist(current: dict[Size, float], target: dict[Size, float]) -> dict[Size, float]:
    return {size: t - current.get(size, 0)
            for size, t in target.items() if t > current.get(size, 0)}


@click.command()
@click.option("--config", "config_file", type=click.File("r"), required=True)
@click.option("--device", default="cuda", show_default=True,
              help="Device to sample on ('cpu' runs without a card).")
def main(config_file: IO[str], device: str):
    dev = resolve_device(device)
    from PIL import Image

    from ..convert.loader import load_components
    from ..diffusion.sampler import SamplerSpec, cast_params, fold_seed, sample_images
    from ..text.tokenizer import resolve_t5_tokenizer, resolve_tokenizer

    config = load_with_defaults(config_file)
    if not config.prior_preservation.get("enabled", False):
        logger.warning("Prior preservation not enabled; class image generation not needed")
        return

    models = load_components(config)
    tokenizer = resolve_tokenizer(config)
    spec = SamplerSpec(unet_config=models.unet_config, vae_config=models.vae_config,
                       clip_config=models.clip_config, schedule=models.schedule,
                       clip_stop_at_layer=int(config.get("clip_stop_at_layer", 1)),
                       clip2_config=models.clip2_config, mmdit_config=models.mmdit_config,
                       t5_config=models.t5_config if models.t5 is not None else None)
    tokenizer_3 = None
    if models.t5 is not None:
        tokenizer_3 = resolve_t5_tokenizer(config)
        if tokenizer_3 is None:
            raise click.UsageError("SD3 model has a T5 tower but no tokenizer_3/tokenizer.json")
    # onto the device once, in the sampling dtype
    unet, vae_params, clip = (cast_params(p, spec.dtype, dev)
                              for p in (models.unet, models.vae, models.clip))
    clip2, t5 = (cast_params(p, spec.dtype, dev) if p is not None else None
                 for p in (models.clip2, models.t5))
    del models
    seed = int(config.get("seed") or 0)

    arb_config = config.aspect_ratio_bucket
    for i, concept in enumerate(config.data.concepts):
        class_config = concept.class_set
        autogen = class_config.get("auto_generate", {}) or {}
        if not autogen.get("enabled", False):
            logger.warning(f"Concept [{i}] skipped: class auto generate not enabled")
            continue

        resolution = config.data.resolution
        if arb_config.get("enabled", False):
            target_dist = get_arb_size_dist(Path(concept.instance_set.path), resolution,
                                            arb_config)
        else:
            target_dist = {(resolution, resolution): 1.0}

        image_dir = Path(class_config.path)
        image_dir.mkdir(parents=True, exist_ok=True)
        delta = get_delta_dist(get_size_dist(image_dir), target_dist)
        counts = {size: round(autogen.num_target * p) for size, p in delta.items()}
        logger.info(f"Concept [{i}]: generating {sum(counts.values())} class images {counts}")

        batch_size = int(autogen.get("batch_size", 1))
        rng_counter = 0
        for (w, h), count in counts.items():
            while count > 0:
                n = min(batch_size, count)
                images = sample_images(
                    unet, vae_params, clip, tokenizer,
                    prompts=[class_config.prompt] * n,
                    negative_prompt=autogen.get("negative_prompt", ""),
                    spec=spec,
                    steps=int(autogen.get("steps", 28)),
                    cfg_scale=float(autogen.get("cfg_scale", 7.5)),
                    method=autogen.get("method", "ddim"),
                    guidance_rescale=float(autogen.get("guidance_rescale", 0.0)),
                    width=w, height=h,
                    generator=torch.Generator(device=dev).manual_seed(
                        fold_seed(seed, rng_counter)),
                    device=dev,
                    clip2_params=clip2,
                    t5_params=t5,
                    tokenizer_3=tokenizer_3,
                )
                rng_counter += 1
                for img in images:
                    arr = np.asarray(img)
                    digest = hashlib.md5(arr.tobytes()).hexdigest()
                    Image.fromarray(arr).save(image_dir / f"{digest}.png")
                count -= n


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
