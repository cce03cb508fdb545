"""Sampling cells: class-image generation as DreamBooth's
``cli/gen_class_imgs.py`` runs it, through the program's
``diffusion/sampler.py`` ``sample_images``: the prompt and the empty
negative prompt through CLIP, the sampler's loop with the CFG pair batched
into one denoiser call, the VAE decoder to uint8 pixels, under inference
mode in the traffic mix's dtype.

The traffic mix gives the batch, the resolution, the sampler and its steps,
the guidance scale, the prompt lengths and the dtype the weights are served
and the sampler computes in. Each batch ``k`` of a run has
its own prompt (token ids drawn from the seed; every image of a batch
shares it, as in the class-image CLI) and its own initial noise (from the
seed), handed to the program through ``SamplerDraws``. One batch of other
draws warms every shape in set-up.

What is compared (``numbers``): the pixels of one batch of the window,
drawn from the seed among those it finished, against the plain reference's
images of the same prompt and noise: the mean absolute gap over all pixels
(``image_gap``) and the largest image's (``image_worst``), in units of the
full range 255.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.weights import derive, generator, make_weights
from benchmark.reference import text_vae
from benchmark.reference.diffusion import ddim_sample

RATE = "sample_images_per_s"
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


class Tokenizer:
    """The benchmark's prompts are their token ids, written out: "12 907 33"
    -> BOS, the ids, EOS, then EOS to the context length."""

    def __init__(self, bos: int, eos: int, length: int):
        self.bos, self.eos, self.length = bos, eos, length

    def __call__(self, prompts: list[str]) -> np.ndarray:
        out = np.full((len(prompts), self.length), self.eos, dtype=np.int64)
        for i, p in enumerate(prompts):
            ids = [self.bos] + [int(w) for w in p.split()][:self.length - 2] + [self.eos]
            out[i, :len(ids)] = ids
        return out


class Work:
    unit_name = "images"
    rate_name = RATE

    def __init__(self, cell, seed: int, device, family, fault: str | None = None):
        self.cell, self.seed, self.device, self.family, self.fault = cell, seed, device, family, fault
        t, cfg = cell.traffic, cell.config
        self.batch, self.images_per_unit = t["batch"], t["batch"]
        self.trace_units = t["trace_batches"]
        te = cfg["text_encoder"]
        self.tokenizer = Tokenizer(te["bos_token_id"], te["eos_token_id"],
                                   te["max_position_embeddings"])
        self.images: list[np.ndarray] = []
        if fault not in (None, "altered"):
            raise ValueError(f"no such sampling fault: {fault!r}")

    def prompt(self, k) -> str:
        t, te = self.cell.traffic, self.cell.config["text_encoder"]
        gen = torch.Generator().manual_seed(derive(self.seed, "prompt", k))
        n = int(torch.randint(t["prompt_tokens"][0], t["prompt_tokens"][1] + 1, (), generator=gen))
        ids = torch.randint(0, te["bos_token_id"], (n,), generator=gen)
        return " ".join(str(int(i)) for i in ids)

    def noise(self, k) -> torch.Tensor:
        t = self.cell.traffic
        shape = (self.batch,) + self.family.latent_shape(self.cell.config, t["resolution"])
        return torch.randn(shape, generator=generator(self.seed, self.device, "noise", k),
                           device=self.device, dtype=DTYPES[t["dtype"]])

    def _weights(self, dtype) -> dict:
        cfg = self.cell.config
        return {"unet": make_weights(self.family.shapes(cfg), derive(self.seed, "unet"),
                                     self.device, dtype),
                "vae": make_weights(text_vae.decoder_shapes(cfg["vae"]),
                                    derive(self.seed, "vae"), self.device, dtype),
                "clip": make_weights(text_vae.clip_shapes(cfg["text_encoder"]),
                                     derive(self.seed, "clip"), self.device, dtype)}

    # --- the program --------------------------------------------------------------

    def setup(self) -> None:
        from scal_sdt_tpu_torch.diffusion.sampler import SamplerSpec
        from scal_sdt_tpu_torch.models.clip import CLIPTextConfig
        from scal_sdt_tpu_torch.models.vae import VAEConfig

        cfg, t = self.cell.config, self.cell.traffic
        te, vae = cfg["text_encoder"], cfg["vae"]
        self.spec = SamplerSpec(
            unet_config=self.family.program_denoiser(cfg),
            vae_config=VAEConfig(in_channels=vae["in_channels"],
                                 out_channels=vae["out_channels"],
                                 latent_channels=vae["latent_channels"],
                                 block_out_channels=tuple(vae["block_out_channels"]),
                                 layers_per_block=vae["layers_per_block"],
                                 norm_num_groups=vae["norm_num_groups"],
                                 scaling_factor=vae["scaling_factor"]),
            clip_config=CLIPTextConfig(vocab_size=te["vocab_size"], hidden_size=te["hidden_size"],
                                       intermediate_size=te["intermediate_size"],
                                       num_hidden_layers=te["num_hidden_layers"],
                                       num_attention_heads=te["num_attention_heads"],
                                       max_position_embeddings=te["max_position_embeddings"],
                                       hidden_act=te["hidden_act"],
                                       eos_token_id=te["eos_token_id"]),
            schedule=self.family.program_schedule(cfg), dtype=DTYPES[t["dtype"]])
        self.weights = self._weights(DTYPES[t["dtype"]])
        self._sample("warm-up")

    def _sample(self, k) -> np.ndarray:
        from scal_sdt_tpu_torch.diffusion.sampler import SamplerDraws, sample_images

        t, w = self.cell.traffic, self.weights
        images = sample_images(w["unet"], w["vae"], w["clip"], self.tokenizer,
                               prompts=[self.prompt(k)] * self.batch, negative_prompt="",
                               spec=self.spec, steps=t["steps"], cfg_scale=t["cfg_scale"],
                               width=t["resolution"], height=t["resolution"],
                               method=t["method"], draws=SamplerDraws(noise=self.noise(k)),
                               device=self.device)
        if self.fault == "altered":
            images = images.copy()
            images[0] = 255 - images[0]
        return images

    def control_inputs(self) -> None:
        """The compared batch's inputs alone, for the control (no program)."""
        self._pick(1)

    def unit(self) -> None:
        self.images.append(self._sample(len(self.images)))

    def _pick(self, batches: int) -> None:
        """The compared batch among ``batches``, drawn from the seed."""
        gen = torch.Generator().manual_seed(derive(self.seed, "compared"))
        self.compared = int(torch.randint(0, batches, (), generator=gen))

    def program_readings(self) -> dict:
        self._pick(len(self.images))
        return {"images": self.images[self.compared]}

    def release(self) -> None:
        self.weights = None

    # --- the reference ------------------------------------------------------------

    @torch.no_grad()
    def reference_readings(self, nx) -> dict:
        cfg, t = self.cell.config, self.cell.traffic
        w = self._weights(DTYPES[t["dtype"]])
        w = {part: {k: v.float() for k, v in leaves.items()} for part, leaves in w.items()}
        k = self.compared
        ids = torch.from_numpy(self.tokenizer([self.prompt(k)] * self.batch)).to(self.device)
        neg = torch.from_numpy(self.tokenizer([""] * self.batch)).to(self.device)
        context = text_vae.clip_forward(w["clip"], torch.cat([neg, ids]), cfg["text_encoder"], nx)
        rows = t["reference_rows"]

        def denoise(x, step):
            pair = torch.cat([x, x])
            ts = torch.full((pair.shape[0],), step, dtype=torch.int64, device=x.device)
            out = torch.cat([self.family.reference_forward(
                w["unet"], pair[s:s + rows], ts[s:s + rows], {"conds": context[s:s + rows]},
                cfg, nx) for s in range(0, pair.shape[0], rows)])
            return out.chunk(2)

        latents = ddim_sample(denoise, self.noise(k).float(), self.family.schedule(cfg),
                              t["steps"], t["cfg_scale"])
        z = latents / cfg["vae"]["scaling_factor"]
        pixels = torch.cat([text_vae.decoder_forward(w["vae"], z[s:s + rows], cfg["vae"], nx)
                            for s in range(0, z.shape[0], rows)])
        images = (torch.clamp(pixels, -1.0, 1.0) + 1.0) * 127.5
        return {"images": images.permute(0, 2, 3, 1).cpu().numpy().astype(np.uint8)}

    # --- the comparison -----------------------------------------------------------

    @staticmethod
    def numbers(prog: dict, ref: dict) -> dict:
        gap = np.abs(prog["images"].astype(np.float64) - ref["images"].astype(np.float64)) / 255.0
        per_image = gap.reshape(gap.shape[0], -1).mean(axis=1)
        return {"image_gap": float(gap.mean()), "image_worst": float(per_image.max())}
