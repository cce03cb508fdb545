"""In-training sampling (port of ``scal_sdt_tpu/training/sample_callback.py``;
reference: modules/sample_callback.py).

Every ``sampling.interval_steps`` optimizer steps, the main process
generates ``num_samples`` images per configured concept with the port's
samplers and writes PNGs to ``run_dir/samples/<step>/``, optionally logging
a gallery to WandB (``loggers.wandb.sample``). LoRA factors in the live
param dict are consumed by the UNet forward as run-time deltas, so samples
show the current adapters.

Each image batch draws from a generator of its own, seeded from the
concept's seed and the number of images made so far (the analogue of JAX's
``fold_in(PRNGKey(seed), len(images))``). Nothing is drawn from the
trainer's generator or torch's global RNG, so a run with sampling on trains
on the same numbers as one without it, and resumes exactly.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from ..diffusion.sampler import SamplerSpec, fold_seed, sample_images
from ..models.functional import sub_params
from ..utils.logging import is_main_process
from .step import TE2_PREFIX, TE3_PREFIX, TE_PREFIX, UNET_PREFIX, VAE_PREFIX

logger = logging.getLogger("sampling")


class SampleCallback:
    def __init__(self, sample_dir: Path):
        self.sample_dir = Path(sample_dir)

    def __call__(self, trainer, global_step: int) -> None:
        sampling = trainer.config.get("sampling")
        if (sampling is None or not sampling.get("concepts")
                or global_step % int(sampling.interval_steps) != 0
                or not is_main_process()):
            return

        from PIL import Image

        merged = trainer.merged_inference_params()
        unet_params = sub_params(merged, UNET_PREFIX)
        vae_params = sub_params(merged, VAE_PREFIX)
        clip_params = sub_params(merged, TE_PREFIX)
        models = trainer.models
        clip2_params = sub_params(merged, TE2_PREFIX) if models.clip2 is not None else None
        t5_params = sub_params(merged, TE3_PREFIX) if models.t5 is not None else None
        spec = SamplerSpec(
            unet_config=models.unet_config, vae_config=models.vae_config,
            clip_config=models.clip_config, schedule=models.schedule,
            clip_stop_at_layer=int(trainer.config.get("clip_stop_at_layer", 1)),
            clip2_config=models.clip2_config, mmdit_config=models.mmdit_config,
            t5_config=models.t5_config if models.t5 is not None else None)

        save_dir = self.sample_dir / str(global_step)
        save_dir.mkdir(parents=True, exist_ok=True)
        batch_size = int(sampling.get("batch_size", 1))
        galleries = {}
        for ci, concept in enumerate(sampling.concepts):
            remaining = int(concept.get("num_samples", 1))
            seed = int(concept.get("seed", 0))
            images = []
            while remaining > 0:
                n = min(batch_size, remaining)
                generator = torch.Generator(device=trainer.device).manual_seed(
                    fold_seed(seed, len(images)))
                out = sample_images(
                    unet_params, vae_params, clip_params, trainer.tokenizer,
                    prompts=[concept.prompt] * n,
                    negative_prompt=concept.get("negative_prompt", ""),
                    spec=spec,
                    steps=int(concept.get("steps", 28)),
                    cfg_scale=float(concept.get("cfg_scale", 7.5)),
                    width=int(concept.get("width", 512)),
                    height=int(concept.get("height", 512)),
                    generator=generator,
                    method=concept.get("method", sampling.get("method", "ddim")),
                    guidance_rescale=float(concept.get(
                        "guidance_rescale", sampling.get("guidance_rescale", 0.0))),
                    device=trainer.device,
                    clip2_params=clip2_params,
                    t5_params=t5_params,
                    tokenizer_3=trainer.pipeline.tokenizer_3,
                )
                images.extend(out)
                remaining -= n
            for j, img in enumerate(images):
                Image.fromarray(img).save(save_dir / f"{ci}-{j}.png")
            galleries[concept.prompt] = images
        logger.info(f"Wrote samples for step {global_step} to {save_dir}")

        for kind, w in trainer._writers:
            if kind == "wandb" and (trainer.config.loggers.get("wandb") or {}).get("sample"):
                import wandb

                w.log({"samples": {p[:230]: [wandb.Image(np.asarray(x)) for x in imgs]
                                   for p, imgs in galleries.items()}}, step=global_step)
