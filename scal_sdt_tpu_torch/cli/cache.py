"""Offline latent/condition cache builder (port of ``scal_sdt_tpu/cli/cache.py``).

One pass of VAE encode (and CLIP encode of the prompts) over the training
set on one device, written as a single safetensors file keyed
``{id}.latent.{g}`` / ``{id}.cond`` (and for SDXL ``{id}.pooled``, tower 2's
pooled projected embedding, beside the concatenated penultimate states of
both towers in ``{id}.cond``; for SD3 ``{id}.cond`` holds the whole prompt
embedding of ``models/mmdit.encode_sd3``, T5's states included when the
model has T5, and ``{id}.pooled`` both towers' pooled projections) with the
reference's metadata schema
{sizes, entries, total_entries, aug_group_size}: the file the JAX package
writes, which either package's ``LatentCache`` reads. Latents are stored
(h, w, c) HWC, in the dtype of the VAE weights (the encode runs in it).

``--aug-group-size N`` stores N augmented latent variants per image;
training samples one uniformly. With ARB on, the epoch order is
data-dependent, so augmentation + ARB caching is rejected.

Run it as ``python -m scal_sdt_tpu_torch.cli.cache --config cfg.yaml``
(``--device cpu`` without a card), or on N cards of a host as ``python -m
torch.distributed.run --nproc_per_node N -m scal_sdt_tpu_torch.cli.cache
...``: each rank encodes its sampler shard on ``cuda:LOCAL_RANK`` (padded to
the common batch count), the shards are gathered on rank 0 in rank order
(``merge_shards``, as the JAX package's ``build_local_shard`` +
``merge_shards``) and rank 0 writes one complete cache. Distributed caching
needs ARB off, as in the JAX package. An SD3 model with T5 needs
``tokenizer_3/tokenizer.json`` to cache conditions (or ``--no-conds``).
"""

from __future__ import annotations

import itertools
import json
import logging
from pathlib import Path
from typing import IO, Callable, Optional

import click
import numpy as np
import torch
import torch.distributed as dist

from ..conf import Config, load_with_defaults
from ..data.pipeline import DataPipeline, get_dataset, get_sampler, to_device
from ..device import resolve_device
from ..models.clip import clip_text_apply, encode_sdxl
from ..models.mmdit import encode_sd3
from ..models.vae import encoder_apply, latent_noise, sample_latents
from ..parallel.mesh import LaunchEnv, init_process_group, process_device
from ..utils.logging import main_process_logger
from ..utils.state import save_state_dict

logger = main_process_logger("cache")

# moments (B, 2C, h, w) -> the standard normal draw of their sample
NoiseFn = Callable[[torch.Tensor], torch.Tensor]


class _PaddedSampler:
    """Pads a sampler's index stream to `total` entries by repeating its last
    index, so every dataset entry lands in a full batch (duplicates overwrite
    the same cache keys at assembly)."""

    def __init__(self, sampler, total: int):
        self.sampler = sampler
        self.total = total

    def __iter__(self):
        last = None
        n = 0
        for idx in self.sampler:
            last = idx
            n += 1
            yield idx
        for _ in range(self.total - n):
            yield last

    def __len__(self) -> int:
        return self.total


def latent_noise_source(seed: int, device: torch.device) -> NoiseFn:
    """The latent noise of each batch in turn, from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return lambda moments: latent_noise(moments, gen)


@torch.no_grad()
def build_local_shard(config: Config, models, tokenizer, *,
                      no_conds: bool, aug_group_size: int, batch_size: int,
                      world_size: int = 1, global_rank: int = 0, device="cuda",
                      noise: Optional[NoiseFn] = None) -> dict:
    """Encode this process's dataset shard on ``device``.

    Returns {'ids': (N,) int64, 'latents': G lists of N (h, w, c) CPU
    tensors, 'conds': (N, L, D) CPU tensor or None, 'pooled': (N, D2) CPU
    tensor (SDXL, SD3) or None}. The shard is padded up
    to whole batches by repeating its last entry, so no tail entry is
    dropped. ``noise`` gives each batch's latent noise (default
    ``latent_noise_source`` seeded with ``config.seed``)."""
    dev = resolve_device(device)
    dataset = get_dataset(config, use_cache=False)
    sampler = get_sampler(dataset, config, world_size, global_rank)
    if len(dataset) == 0:
        raise ValueError("Dataset is empty; nothing to cache")

    max_shard = -(-len(dataset) // world_size)
    n_batches = -(-max_shard // batch_size)
    target = n_batches * batch_size
    pad = target - len(sampler)
    if pad:
        logger.info(f"Rank {global_rank}: padding shard of {len(sampler)} "
                    f"entries with {pad} repeats to fill {n_batches} batches")
    sampler = _PaddedSampler(sampler, target)
    tokenizer_3 = None
    if models.t5 is not None and not no_conds:
        from ..text.tokenizer import resolve_t5_tokenizer

        tokenizer_3 = resolve_t5_tokenizer(config)
        if tokenizer_3 is None:
            raise ValueError("SD3 model has a T5 tower: caching conditions needs "
                             "tokenizer_3/tokenizer.json (or pass --no-conds)")
    pipeline = DataPipeline(dataset, sampler, batch_size, tokenizer,
                            num_workers=config.get("num_workers") or 4, tokenizer_3=tokenizer_3)

    vae_params = {k: v.to(dev) for k, v in models.vae.items()}
    clip_params = {k: v.to(dev) for k, v in models.clip.items()}
    vae_dtype = vae_params["encoder.conv_in.weight"].dtype
    stop_at_layer = int(config.get("clip_stop_at_layer", 1))
    if noise is None:
        noise = latent_noise_source(int(config.get("seed") or 0), dev)

    if models.is_sd3:
        # SD3: the live-encode conditioning of training/step.py
        clip2_params = {k: v.to(dev) for k, v in models.clip2.items()}
        t5_params = ({k: v.to(dev) for k, v in models.t5.items()}
                     if models.t5 is not None else None)

        def encode_conds(input_ids, t5_ids=None):
            t5 = ({"t5_params": t5_params, "t5_ids": t5_ids, "t5_config": models.t5_config}
                  if t5_params is not None else {})
            return encode_sd3(clip_params, clip2_params, input_ids, models.clip_config,
                              models.clip2_config, models.mmdit_config.joint_attention_dim,
                              **t5)
    elif models.clip2 is not None:
        # SDXL: the live-encode conditioning of training/step.py
        clip2_params = {k: v.to(dev) for k, v in models.clip2.items()}

        def encode_conds(input_ids):
            return encode_sdxl(clip_params, clip2_params, input_ids, models.clip_config,
                               models.clip2_config)
    else:
        def encode_conds(input_ids):
            return clip_text_apply(clip_params, input_ids, models.clip_config,
                                   stop_at_layer), None

    groups: list[list[torch.Tensor]] = []
    ids: Optional[np.ndarray] = None
    conds: Optional[torch.Tensor] = None
    pooled: Optional[torch.Tensor] = None
    for group in range(aug_group_size):
        lat_images: list[torch.Tensor] = []
        id_batches, cond_batches, pooled_batches = [], [], []
        for batch in itertools.islice(iter(pipeline), n_batches):
            on_dev = to_device(batch, dev)
            moments = encoder_apply(vae_params, on_dev["images"].to(vae_dtype),
                                    models.vae_config)
            lat = sample_latents(moments, noise(moments), models.vae_config.scaling_factor,
                                 models.vae_config.shift_factor)
            lat_images.extend(lat.permute(0, 2, 3, 1).cpu().unbind(0))
            id_batches.append(np.asarray(batch["ids"], np.int64))
            if group == 0 and not no_conds and "input_ids" in batch:
                c, p = (encode_conds(on_dev["input_ids"], on_dev["t5_ids"])
                        if "t5_ids" in on_dev else encode_conds(on_dev["input_ids"]))
                cond_batches.append(c.cpu())
                if p is not None:
                    pooled_batches.append(p.cpu())
        group_ids = np.concatenate(id_batches)
        if ids is None:
            ids = group_ids
        elif not np.array_equal(ids, group_ids):
            raise AssertionError("Sampler order changed between aug groups")
        groups.append(lat_images)
        if cond_batches:
            conds = torch.cat(cond_batches)
        if pooled_batches:
            pooled = torch.cat(pooled_batches)

    return {"ids": ids, "latents": groups, "conds": conds, "pooled": pooled}


def merge_shards(shards: list[dict]) -> dict:
    """The ranks' shards (in rank order) as one: ids, each group's latents,
    conds and pooled embeddings concatenated rank after rank."""
    if len(shards) == 1:
        return shards[0]

    def cat(key):
        parts = [s[key] for s in shards]
        return None if parts[0] is None else torch.cat(parts)

    return {"ids": np.concatenate([s["ids"] for s in shards]),
            "latents": [[t for s in shards for t in s["latents"][g]]
                        for g in range(len(shards[0]["latents"]))],
            "conds": cat("conds"), "pooled": cat("pooled")}


def gather_shards(shard: dict, env: LaunchEnv) -> Optional[list[dict]]:
    """Every rank's shard on rank 0 (None elsewhere), over a gloo group."""
    if env.world == 1:
        return [shard]
    group = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else None
    out = [None] * env.world if env.rank == 0 else None
    dist.gather_object(shard, out, dst=0, group=group)
    return out


def assemble_cache(merged: dict) -> tuple[dict, dict]:
    """(tensors, metadata) in the reference's file schema. Each tensor is its
    own copy (safetensors refuses tensors that share memory)."""
    ids = merged["ids"]
    latents = merged["latents"]
    conds = merged["conds"]
    aug_group_size = len(latents)

    cache: dict[str, torch.Tensor] = {}
    sizes: dict[str, list] = {}
    for group in range(aug_group_size):
        for i, id_ in enumerate(ids):
            key = f"{int(id_)}.latent.{group}"
            cache[key] = latents[group][i].clone()
            sizes[key] = list(cache[key].shape)
    if conds is not None:
        for i, id_ in enumerate(ids):
            cache[f"{int(id_)}.cond"] = conds[i].clone()
    if merged.get("pooled") is not None:
        for i, id_ in enumerate(ids):
            cache[f"{int(id_)}.pooled"] = merged["pooled"][i].clone()

    # Padding repeats ids; the per-key overwrites above already dedup the
    # tensors, and total_entries must be the UNIQUE count (it is consumed as
    # the dataset length by the cache-backed training path).
    entries = sorted({int(i) for i in ids})
    metadata = {
        "sizes": sizes,
        "entries": entries,
        "total_entries": len(entries),
        "aug_group_size": aug_group_size,
    }
    return cache, metadata


@click.command()
@click.option("--config", "config_file", type=click.File("r"), required=True,
              help="Path to the training config.")
@click.option("--no-conds", is_flag=True,
              help="Do not cache conditions (useful when training the text encoder).")
@click.option("--aug-group-size", type=int, default=16,
              help="Number of augmented latent variants per entry.")
@click.option("--batch-size", type=int, default=1,
              help="Batch size for VAE and text encoder.")
@click.option("--device", default="cuda", show_default=True,
              help="Device to encode on ('cpu' runs without a card; 'cuda' is "
                   "cuda:LOCAL_RANK under torch.distributed.run).")
@click.option("--backend", default=None,
              help="torch.distributed backend over the device's default (nccl on cards, "
                   "gloo on the CPU).")
def main(config_file: IO[str], no_conds: bool, aug_group_size: int, batch_size: int,
         device: str, backend: Optional[str]):
    """Generate the latent/condition cache at config entry data.cache."""
    from ..convert.loader import load_components
    from ..text.tokenizer import resolve_tokenizer

    env = LaunchEnv.from_environ()
    dev = resolve_device(process_device(device, env))
    config = load_with_defaults(config_file)
    config["batch_size"] = batch_size

    if config.data.get("cache") is None:
        raise click.UsageError("data.cache is not set")

    arb = config.aspect_ratio_bucket.get("enabled", False)
    if config.get("augment") is None:
        if aug_group_size != 1:
            logger.warning("Augmentation not enabled; forcing aug group size 1")
            aug_group_size = 1
    elif arb:
        raise click.UsageError(
            "Caching is incompatible with ARB + augmentation together "
            "(ARB batch entry order is random)")

    if env.world > 1 and arb:
        raise click.UsageError(
            "Distributed caching requires ARB off (per-rank batch shapes "
            "must align; the reference declares the same limitation)")
    init_process_group(dev, backend, env)

    models = load_components(config)
    tokenizer = resolve_tokenizer(config, allow_hash=no_conds)
    shard = build_local_shard(
        config, models, tokenizer, no_conds=no_conds, aug_group_size=aug_group_size,
        batch_size=batch_size, world_size=env.world, global_rank=env.rank, device=dev)
    shards = gather_shards(shard, env)
    if shards is None:
        logger.info("Non-zero process: shard contributed, rank 0 writes")
        return

    cache, metadata = assemble_cache(merge_shards(shards))
    out = Path(config.data.cache)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_state_dict(cache, out, "safetensors", metadata={"json": json.dumps(metadata)})
    logger.info(f'Saved cache ({metadata["total_entries"]} entries x '
                f'{metadata["aug_group_size"]} groups) to "{out}"')


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
