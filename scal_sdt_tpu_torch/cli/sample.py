"""Text-to-image sampling CLI (port of ``scal_sdt_tpu/cli/sample.py``).

    python -m scal_sdt_tpu_torch.cli.sample --model sd15_dir --prompt "a corgi" \\
        --steps 28 --cfg 7.5 --out out/ [--ckpt run/step8.safetensors] [--device cuda]

Runs ``diffusion/sampler.py`` (DDIM, Euler, Euler-a, DPM++(2M), with CFG
rescale and img2img; SD3 by the flow-matching Euler ODE, which ``ddim`` also
selects there) on a model the trainer can load: a diffusers directory
(SD1.x, SD2.x, SDXL or SD3, whose T5 tokenizer is ``--tokenizer-3`` or the
directory's ``tokenizer_3/``) or a single-file checkpoint (an SD1.x LDM
file with the bundled v1 architecture, SDXL's or SD3's sgm file; an SD3
file takes ``--mmdit-head-dim`` and ``--pos-embed-max-size``, and a single
file needs ``--tokenizer``; an SD2.x file needs its LDM YAML, which only the
API takes, ``load_components`` with ``ldm_config``, as in the JAX package),
optionally overlaying a training checkpoint: a full fine-tune's tensors or
LoRA factors (which the UNet forward consumes as run-time deltas) from
either package's ``.safetensors`` file, or a kohya / AddNet LoRA file; the
checkpoint's trained textual-inversion keywords are registered with the
tokenizer. Samples run on a card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import click
import numpy as np

from ..device import resolve_device

logger = logging.getLogger("sample")


def merge_checkpoint(models, ckpt_path: Path) -> dict:
    """Overlay a training checkpoint's trainable tensors (and LoRA factors)
    onto the loaded components, in place. kohya/AddNet LoRA files are
    detected and imported. Returns the checkpoint metadata (``ti_tokens``
    for trained TI keywords)."""
    from ..convert.kohya import from_kohya_format, is_kohya_lora
    from ..training.checkpoint import load_checkpoint_tensors
    from ..training.step import TE2_PREFIX, TE_PREFIX, UNET_PREFIX, VAE_PREFIX

    tensors, meta = load_checkpoint_tensors(ckpt_path)
    if is_kohya_lora(tensors):
        logger.info("Checkpoint is a kohya/AddNet LoRA file; importing")
        tensors = from_kohya_format(
            tensors, models.unet.keys(), models.clip.keys(),
            te2_names=models.clip2.keys() if models.clip2 is not None else None)
    targets = {UNET_PREFIX: models.unet, TE_PREFIX: models.clip, VAE_PREFIX: models.vae}
    if models.clip2 is not None:
        targets[TE2_PREFIX] = models.clip2
    merged = {p: 0 for p in targets}
    for key, value in tensors.items():
        if key.startswith("unet_ema."):
            continue  # the EMA is published with `ckpt_tool prune --ema` instead
        for prefix, params in targets.items():
            if key.startswith(prefix + "."):
                params[key[len(prefix) + 1:]] = value
                merged[prefix] += 1
                break
    logger.info("Merged checkpoint tensors: " +
                ", ".join(f"{p}={n}" for p, n in merged.items() if n))
    return meta


@click.command()
@click.option("--model", required=True,
              help="LDM .ckpt/.safetensors file or diffusers directory")
@click.option("--prompt", "prompts", multiple=True, required=True,
              help="Prompt (repeat for a batch of different prompts)")
@click.option("--negative", default="", help="Negative prompt")
@click.option("--ckpt", type=click.Path(exists=True, path_type=Path), default=None,
              help="Training checkpoint to overlay (full-FT or LoRA, or a kohya LoRA file)")
@click.option("--vae", default=None, help="External VAE (a directory, or a file for a "
              "single-file model)")
@click.option("--num", default=1, show_default=True, help="Images per prompt")
@click.option("--steps", default=28, show_default=True)
@click.option("--cfg", default=7.5, show_default=True)
@click.option("--width", default=512, show_default=True)
@click.option("--height", default=512, show_default=True)
@click.option("--seed", default=42, show_default=True)
@click.option("--method", default="ddim", show_default=True,
              type=click.Choice(["ddim", "euler", "euler_a", "dpmpp_2m", "flow_euler"]),
              help="Sampler (euler/euler_a/dpmpp_2m are k-diffusion style; SD3 models "
                   "sample with flow_euler, which ddim selects there)")
@click.option("--guidance-rescale", default=0.0, show_default=True,
              help="CFG rescale phi (arXiv:2305.08891; ~0.7 for zero-terminal-SNR "
                   "v-prediction models)")
@click.option("--init-image", type=click.Path(exists=True, path_type=Path), default=None,
              help="img2img init image")
@click.option("--strength", default=0.75, show_default=True,
              help="img2img denoising strength (1.0 ignores the init)")
@click.option("--clip-skip", default=1, show_default=True,
              help="CLIP stop-at-layer (reference clip_stop_at_layer)")
@click.option("--tokenizer", "tokenizer_src", default=None,
              help="Tokenizer assets dir ('hash' for the test stand-in)")
@click.option("--tokenizer-3", "tokenizer_3_src", default=None,
              help="T5 tokenizer.json (or its directory) of SD3 models with T5 (default: "
                   "the model directory's tokenizer_3/)")
@click.option("--mmdit-head-dim", type=int, default=64, show_default=True,
              help="MMDiT attention head dim of SD3 single-file models (every SD3 / SD3.5 "
                   "release uses 64; tiny fixtures differ)")
@click.option("--pos-embed-max-size", type=int, default=None,
              help="MMDiT sincos grid size of SD3 single files without the pos_embed buffer "
                   "(default 192 = SD3-Medium)")
@click.option("--out", type=click.Path(path_type=Path), default=Path("samples"),
              show_default=True)
@click.option("--device", default="cuda", show_default=True,
              help="Device to sample on ('cpu' runs without a card).")
def main(model, prompts, negative, ckpt, vae, num, steps, cfg, width, height, seed, method,
         guidance_rescale, init_image, strength, clip_skip, tokenizer_src, tokenizer_3_src,
         mmdit_head_dim, pos_embed_max_size, out, device):
    dev = resolve_device(device)

    from PIL import Image

    from ..conf import Config, default, merge
    from ..convert.loader import load_components
    from ..diffusion.sampler import SamplerSpec, cast_params, sample_images
    from ..text.tokenizer import resolve_t5_tokenizer, resolve_tokenizer

    config = merge(default(), Config({
        "model": str(model), "vae": vae, "clip_stop_at_layer": int(clip_skip),
        "mmdit_head_dim": int(mmdit_head_dim),
        **({"mmdit_pos_embed_max_size": int(pos_embed_max_size)} if pos_embed_max_size else {}),
        **({"tokenizer": tokenizer_src} if tokenizer_src else {}),
        **({"tokenizer_3": tokenizer_3_src} if tokenizer_3_src else {}),
    }))
    models = load_components(config)
    tokenizer = resolve_tokenizer(config, allow_hash=tokenizer_src == "hash")
    if ckpt is not None:
        meta = merge_checkpoint(models, ckpt)
        if meta.get("ti_tokens"):
            # trained TI keywords: placeholder tokens that resolve to the
            # trained_extra rows
            from ..text.ti import register_ti_tokens_for_inference

            register_ti_tokens_for_inference(tokenizer, meta["ti_tokens"])
            logger.info("Registered trained TI keywords: " +
                        ", ".join(e["keyword"] for e in meta["ti_tokens"]))

    spec = SamplerSpec(unet_config=models.unet_config, vae_config=models.vae_config,
                       clip_config=models.clip_config, schedule=models.schedule,
                       clip_stop_at_layer=int(clip_skip), clip2_config=models.clip2_config,
                       mmdit_config=models.mmdit_config,
                       t5_config=models.t5_config if models.t5 is not None else None)
    tokenizer_3 = None
    if models.t5 is not None:
        tokenizer_3 = resolve_t5_tokenizer(config)
        if tokenizer_3 is None:
            raise click.UsageError("SD3 model has a T5 tower but no tokenizer_3/tokenizer.json "
                                   "(pass --tokenizer-3 or remove text_encoder_3/)")
    # onto the device once, in the sampling dtype: sample_images' own cast is
    # then a no-op for every call
    unet, vae_params, clip = (cast_params(p, spec.dtype, dev)
                              for p in (models.unet, models.vae, models.clip))
    clip2, t5 = (cast_params(p, spec.dtype, dev) if p is not None else None
                 for p in (models.clip2, models.t5))
    del models

    init_arr = None
    if init_image is not None:
        img = Image.open(init_image).convert("RGB").resize((int(width), int(height)),
                                                           Image.LANCZOS)
        init_arr = np.asarray(img).astype(np.float32) / 127.5 - 1.0

    out.mkdir(parents=True, exist_ok=True)
    batch = list(prompts)
    for rep in range(int(num)):
        t0 = time.perf_counter()
        images = sample_images(
            unet, vae_params, clip, tokenizer, batch, negative, spec, steps=int(steps),
            cfg_scale=float(cfg), width=int(width), height=int(height), seed=int(seed) + rep,
            method=method, init_image=init_arr, strength=float(strength),
            guidance_rescale=float(guidance_rescale), device=dev, clip2_params=clip2,
            t5_params=t5, tokenizer_3=tokenizer_3)
        dt = time.perf_counter() - t0   # images come back on the host: the loop is done
        for i, img in enumerate(images):
            path = out / f"{i:02d}_{rep:02d}.png"
            Image.fromarray(img).save(path)
            logger.info(f"Wrote {path}")
        logger.info(f"Batch {rep}: {len(batch)} image(s) in {dt:.3f} s")
    logger.info(f"Done: {len(batch) * int(num)} image(s) in {out}")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
