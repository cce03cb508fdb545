"""mfu.sample: the sampling window's model FLOPs over the card's dense bf16
peak, in %. An image counts its share of the batch's CLIP passes (the prompt
and the negative prompt), every denoiser call of the ladder on its CFG pair,
and its VAE decode: matmul and convolution FLOPs, attention's products
included, counted on the meta device from the plain reference."""

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import text_vae
from benchmark.reference.numerics import Numerics


def _count(fn, shapes, *inputs):
    meta = torch.device("meta")
    p = {k: torch.empty(s, device=meta) for k, s in shapes.items()}
    with FlopCounterMode(display=False) as counter:
        fn(p, *inputs)
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=4)
def per_image(cfg_json: str, traffic_json: str, family) -> float:
    cfg, t = json.loads(cfg_json), json.loads(traffic_json)
    meta, nx = torch.device("meta"), Numerics()
    te, vae = cfg["text_encoder"], cfg["vae"]
    ids = torch.zeros(1, te["max_position_embeddings"], dtype=torch.long, device=meta)
    clip = _count(lambda p, i: text_vae.clip_forward(p, i, te, nx), text_vae.clip_shapes(te), ids)
    c, h, w = family.latent_shape(cfg, t["resolution"])
    z = torch.empty(1, vae["latent_channels"], h, w, device=meta)
    decode = _count(lambda p, x: text_vae.decoder_forward(p, x, vae, nx),
                    text_vae.decoder_shapes(vae), z)
    denoise = family.forward_flops(cfg, t["resolution"], te["max_position_embeddings"])
    return 2 * clip + t["steps"] * 2 * denoise + decode


def read(ctx):
    if ctx.peaks is None:
        return None
    cfg, t = ctx.cell.config, ctx.cell.traffic
    flops = per_image(json.dumps(cfg, sort_keys=True), json.dumps(t, sort_keys=True), ctx.family)
    return 100.0 * flops * ctx.window["images"] / ctx.window["seconds"] / ctx.peaks["bf16_flops"]
