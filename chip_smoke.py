#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (scal_sdt_tpu_torch) on one NVIDIA card.

Usage, from the root of a checkout, on a machine with a Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0] [--steps 5]

Phases (any failure raises and the script exits non-zero):

1. build   -- compile the port's kernels from scal_sdt_tpu_torch/ops/csrc with
              nvcc for sm_90a (one nvcc per source, in parallel): splash fwd,
              dq, dkv; the int8 Adam update (adam8_fused); the fused Adam
              update over stored moments (adam_bf16_fused). Prints ptxas's
              registers and spill bytes per kernel instance.
2. kernels -- at the main path's shapes, (8,8,4096,40) and (8,8,1024,80) bf16,
              plus the ARB length (1,8,1344,40) that no block divides: each
              splash kernel (fwd, dq, dkv) against its plain PyTorch version
              on the same inputs, then the autograd Function against autograd
              of splash_attention_reference. Bounds: forward 5e-3 max-abs,
              its lse 1e-4, dq/dk/dv 1.5e-2 relative (those of the JAX splash
              tests), the delta dq writes for dkv 1e-5 of its largest entry;
              a second launch of fwd, dq and dkv must give the same bits.
              Times of the kernel, its plain version, torch's SDPA forward
              (with the forward's time over it) and backward (the backward computes
              dq, dk and dv together; its calls are timed queued behind a
              spin kernel, so that the host's time to issue them does not
              count; beside it the time of the pair dq + dkv and the pair
              over SDPA's backward; each kernel's device time alone, queued
              behind a spin kernel), and the least
              time the card could take (HBM bytes, tensor-core flops, or
              exponentials on the exponential unit at the card's SM count
              and maximum SM clock, whichever is largest).
3. optim   -- the optimizer kernels against their plain versions, in both
              forms. Update-only, one leaf at SD1.5 leaf shapes: adam8_fused
              at (1280, 23040) and the ragged (320, 2880), from a state
              quantized by one plain step (payloads at most 1 apart in under
              1e-3 of them, scales and step within 1e-6 relative);
              adam_bf16_fused at (1280, 23040) with bf16 moments and the nu
              SR store (AdamW's form) and at (320,) with fp32 moments (the
              int8 path's small leaves): moments bit for bit, step within
              1e-6 relative; and at (1280, 23040) in its xla mode (the
              default AdamW: fp32 moments, XLA's rounding of plain
              scale_by_adam), step and moments bit for bit. Grouped (Adam,
              decay, schedule and the master apply in one launch over a
              leaf table), over all 686 SD1.5 leaves: AdamW's
              adam_bf16_fused with bf16 masters and moments, and in the xla
              mode with fp32 ones, masters and moments bit for bit; AdamW8bit's
              adam8_fused over its 227 int8 leaves (payloads and scales as
              above, masters at most one bf16 ulp apart in under 1e-3 of
              them) and adam_bf16_fused over its 459 fp32-moment leaves (bit
              for bit). Times of kernel and plain version, the bytes bound,
              and for adam_bf16_fused torch._fused_adamw_ over the same leaf
              or the same 686 bf16 lists (the nearest library call, not the
              same function).
4. train   -- the SD1.5 full fine-tune step at full width: 512^2 (64^2 latents),
              batch 8, cached random latents/conds from --seed, bf16 masters,
              bf16 moments, EMA off, no remat. 3 warm-up steps, then --steps
              timed steps with the launch counts reset just before: each
              splash kernel must launch 10 times per step and adam_bf16_fused
              once (the update and master apply of every leaf of the 7
              groups of the full_unet target, each group with its own
              scalars);
              loss finite, params moved. Prints the model FLOPs per step
              (utils/flops.py: 3 x the UNet forward's matmuls and
              convolutions) and MFU against the card's dense bf16 peak, with
              the card's name and power limit.
5. check   -- one sample through the UNet with the kernels and with the plain
              attention path: the outputs must agree.
6. int8    -- the same workload with optimizer bitsandbytes.optim.AdamW8bit
              (int8 moments): 3 warm-up and --steps timed steps; per step
              adam8_fused launches once per param group with int8 leaves (4
              of the 7 hold the 227), adam_bf16_fused once over every
              group's fp32-moment leaves (the 459), each splash kernel 10
              times; loss finite, params moved.
7. uncached -- (the images through the native decoder, its build named:
              the phase fails if it did not build and PIL would decode;
              then one epoch of the pipeline alone and 3 steps with the
              native decoder and with PIL on the same PNGs)
              the uncached SD1.5 fine-tune at full width: the UNet as in
              train, VAEConfig.sd15() and CLIPTextConfig.vit_l() with random
              weights from --seed (frozen, bf16), batches of 8 at 512^2 from
              the port's DataPipeline over 24 PNG files (720x576 and
              576x720, so resize and crop run) with .txt captions,
              tokenized by CLIPBPETokenizer on a synthetic vocab written
              here, CFG dropout uncond {enabled, p 0.1, cond zeros}. 3
              warm-up and --steps timed steps: each splash kernel 10
              launches per step (the VAE's D = 512 and CLIP's causal
              attention take the math path, as on the TPU), adam_bf16_fused
              1; loss finite, params moved. Prints steps/s, peak memory and
              the device ms of the VAE encode and of CLIP per step (calls
              queued behind a spin kernel). Consistency: on one batch with
              fixed draws (the CFG drop on, then off) the uncached
              compute_loss equals, bit for bit, compute_loss on latents and
              conds computed apart from the public functions.
8. cache   -- the port's cache builder (build_local_shard, assemble_cache,
              save_state_dict) on the same images with the same VAE and
              CLIP held in memory, decoding natively (else it fails):
              images/s of the encode, decoding included; the file read back through LatentCache,
              DataPipeline and to_device; 2 cached train steps from it, loss
              finite.
9. trainer -- the Trainer through the train CLI on that cache file: a
              diffusers directory of SD1.5 at full width in bf16 (a random
              UNet from --seed, the phases' VAE and CLIP, the SD1.5
              scheduler, the synthetic vocab); run 1 (--config) trains 6
              steps of batch 8 (3 per epoch), AdamW with bf16 masters and
              moments, checkpoints at step 4 (mid-epoch) and step 6; run 2
              (--resume from step 4) ends on a checkpoint and sidecar equal
              to run 1's bit for bit (file digests) and run 1's losses. Each
              splash kernel 10 launches per step, adam_bf16_fused one. Then
              a Trainer with accumulate_grad_batches 2
              over 4 micro-steps: the masters move on micro-steps 2 and 4
              only, the optimizer kernels launch on those alone (with the
              fp32 mean of the gradients). Prints the trainer's own steps/s
              beside the train phase's (and the train phase's with a host
              sync per step, as the trainer's logging makes), time to the
              first step, checkpoint write and read seconds and size, peak
              memory, launches per step.
9b. tuner  -- the batch-size tuner at SD1.5 full width: the trainer phase's
              config with trainer.auto_scale_batch_size power from batch 32
              and model: a hub id, resolved through an HF cache written in
              the temp dir (HF_HUB_CACHE, inherited by the probes) to the
              trainer phase's directory; a cache of 768 seeded rows (enough
              that every probe step is a real step up to batch 256). Each
              trial is a probe subprocess (python -m
              scal_sdt_tpu_torch.cli.probe_batch: exit 0 fits, 3 a CUDA OOM);
              at least one must fit and one end in the allocator's CUDA
              out-of-memory error, and the pick be the largest power of two
              that fit. Then 2 steps at the pick in this process: each splash
              kernel 10 launches per step, adam_bf16_fused 1; losses finite,
              masters moved. Prints each trial's batch, exit code, seconds
              and peak memory (the card's error for an OOM).
9c. tuner_world -- the tuner over one host's world: the train CLI under
              python -m torch.distributed.run on 2 ranks sharing the card
              over gloo (given explicitly; the mesh data 2), the trainer
              phase's config with power from batch 32 over 192 seeded rows.
              Rank 0 runs one search while no rank holds a process group or
              a CUDA context; each trial is a world of 2 probe ranks on the
              run's mesh, read from their report files: 32 must fit on both
              ranks (3 real steps each) and 64 end in the allocator's CUDA
              out-of-memory error; then both ranks train 2 steps at the
              pick, 32 (16 rows a rank): each splash kernel 10 launches per
              step and adam_bf16_fused 1 on each rank. Two ranks on one card
              check the mechanism, not speed on N cards.
9d. custom_diffusion -- BASELINE workload 5 at SD1.5 full width: the
              custom_diffusion optim target (the 32 cross-attention K/V
              projections, 32 groups) through the train CLI, 3 cached steps
              of batch 8 at 512^2 from the trainer phase's directory and
              cache, AdamW with fp32 masters: splash_fwd 10 per step, the
              backward kernels only where a trained K/V lies upstream,
              adam_bf16_fused 1 per step (over the 32 groups). ckpt_tool
              prune --arch sd1
              --unet-dtype fp16 of its checkpoint (the 32 leaves) writes the
              partial WebUI file, each K/V the trained master in fp16; the
              trained leaves over the directory's weights, pruned with
              --text-encoder --df-vae at fp16, reload through
              load_ldm_checkpoint with every UNet tensor the directory's in
              fp16 but the 32 K/V, which are the trained weights in fp16.

10. ema   -- the port's own EMA kernel (ema_fused: JAX computes the EMA in
              XLA) in one launch over the 686 SD1.5 leaves, with fp32 and
              with bf16 shadows of bf16 masters, bit for bit against its
              plain version, timed beside its bytes bound and
              torch._foreach_lerp_ over fp32 lists; then the train phase's
              step with EMA on, an fp32 shadow and then a bf16 one, 3 warm-up
              and --steps timed steps each: ema_fused once per step (one
              table over every shadow) beside the train phase's launches, the
              shadows
              moving; then 4 micro-steps at accumulate_grad_batches 2 from
              the bf16 run's state: the EMA moves on all four, the masters on
              2 and 4 only. Prints the EMA kernel's ms against its bound,
              steps/s beside the train phase's, peak memory, launches.
11. lora   -- the port's configs/lora.yaml (UNet and CLIP LoRA, rank 16, remat,
              ARB, batch 4) through the train CLI on the trainer phase's
              diffusers directory and the uncached phase's PNGs (720x576 and
              576x720: non-square buckets), with the file's in-training
              sampling cut to every 4 steps and 2 images: 6 steps with a
              mid-epoch checkpoint at step 4 (sampled just before it: PNGs in
              samples/4/), a run resumed from it that must end on the same
              checkpoint bytes, then 2 steps with LoRA dropout 0.1 and a bf16
              EMA shadow. Each step's splash launches must match the gate at
              its bucket's lengths (forward twice under remat; the sampled
              images' forwards on top), adam_bf16_fused one launch per step
              over every LoRA module's group, ema_fused one over every UNet
              factor. Prints steps/s (steps
              over the wall time between their logs, the first step and the
              one after a checkpoint write and the sampling left out), the
              sampling event's seconds, buckets,
              trainable counts, launches per step (the kernels line counts
              all three runs), checkpoint size, peak memory. Then the kernels
              in the lora phase's forms: each splash kernel at the attention
              shapes its buckets gave (as in phase 2, same bounds), and over
              lora.yaml's 264 groups of two fp32 LoRA factors at SD1.5 width,
              adam_bf16_fused as the run's optimizer launches it (fp32
              masters and moments, bf16 gradients, each group's lr and
              decay, one launch over all of them) and ema_fused in one
              launch over the 192 UNet groups' updated masters (fp32 and
              bf16 shadows), bit for bit against their plain versions; the
              launch's device and event time, the optimizer step's host
              time, beside the bytes bound, torch._fused_adamw_ and
              torch._foreach_lerp_.
12. sample -- the sample CLI (python -m scal_sdt_tpu_torch.cli.sample) on the
              trainer phase's directory at the shipped concept's settings
              (configs/dreambooth.yaml: its prompt and negative prompt, 28
              steps, cfg 11, 512^2, seed 114514, CLIP-skip 2): after a
              warm-up image, one image per method (ddim, euler, euler_a,
              dpmpp_2m), one with guidance rescale 0.7, one img2img
              (strength 0.75) and one at 704x512, each run's launches
              counted alone: splash_fwd 10 per UNet call (280 per 512^2
              image), no backward or optimizer kernel. The PNGs are valid
              and decoded from finite latents; the first image made again
              has the same PNG bytes. Then the DDIM loop with the kernels
              against the plain attention path (ops/attention.FORCE_MATH)
              from one noise: the latents after the first step within the
              check phase's bound, the final latents within
              SAMPLE_FINAL_TOL. Prints seconds per image, UNet calls per
              second, launches per image, one UNet call's device and host ms
              and CUDA operations (a torch.profiler trace), the VAE decode's
              and CLIP's device ms, peak memory. splash_fwd is then held in
              sampling's forms under inference mode: (2,8,4096,40),
              (2,8,1024,80), (2,8,5632,40), (2,8,1408,80), against its plain
              version (O 5e-3, lse 1e-4, a second launch equal bit for
              bit), timed beside its bound, its plain version and SDPA's
              forward.
13. dreambooth -- the port's configs/dreambooth.yaml on that directory, the
              PNGs as instance images, cut to 4 class images and 4 steps:
              the class-image CLI (python -m
              scal_sdt_tpu_torch.cli.gen_class_imgs) writes 4 MD5-named
              PNGs at 512^2 and, run again, none; the train CLI trains 4
              steps with prior preservation (2 instance + 2 class images
              per batch). Prints the class images' seconds each and the
              steps/s.
13b. parallel -- (after dreambooth) the data x fsdp x tensor mesh over
              torch.distributed at SD1.5 full width, 512^2, global batch 8,
              2 steps, from the cache phase's file through the trainer
              phase's directory (the default AdamW: fp32 masters and
              moments, lr 1e-4; bf16 compute; remat): the single process
              here, its masters written as the reference; (a) the train CLI
              under python -m torch.distributed.run on 1 rank over NCCL (an
              all-reduce first; the mesh resolved from the world size);
              NCCL's refusal of two ranks on one card, printed; (b) 2 ranks
              sharing the card over gloo, given explicitly, in meshes
              (1,2,1) and (1,1,2). Each rank's masters against the
              reference: within 1e-4 of each tensor's largest entry plus 2
              lr per step, at most PARALLEL_FAR_SHARE of them beyond the
              first term, the update deltas within PARALLEL_DELTA_TOL
              relative L2, losses within 1e-2. A negative control: (1,1,2)
              with the tensor group's sum of the partial gradients skipped
              must fail the share and delta bounds. Prints each run's
              steps/s, peak memory, masters-and-moments GiB and launches;
              then splash at the tensor-parallel form (8,4,4096,40) as in
              phase 2. Two ranks on one card over gloo measure correctness
              and memory, not multi-GPU speed.
14. sdxl   -- SDXL-base at its published widths (the text_time UNet,
              UNetConfig.sdxl, 2.57 B parameters; CLIP ViT-L and OpenCLIP
              bigG with its text_projection; SD's VAE at scaling factor
              0.13025; the SD1.5 scheduler config; the synthetic vocab),
              random bf16 weights from --seed, written as a diffusers
              directory once (about 7 GB, in place of the SD1.5 one) and six
              PNGs at 1024x1024, 1152x896 and 896x1152. The SDXL phases on
              them, each with the port's configs/sdxl_lora.yaml (LoRA rank 16
              on the UNet and both towers: 986 groups, remat, ARB at 1024,
              batch 1, AdamW):
              sdxl_cache: the cache CLI at 1024 ARB writes {id}.cond (both
              towers' penultimate states) and {id}.pooled for every image,
              then the train CLI trains 2 steps from that file;
              sdxl_lora: the train CLI uncached, 6 steps with a mid-epoch
              checkpoint at 4 and the file's sampling cut to one event of 2
              images (24 DPM++(2M) steps, cfg 7, 1024^2) before it, then a
              run resumed from step 4 that must end on the same checkpoint
              bytes and losses; splash launches per step match the gate at
              each bucket (70 self-attentions at 1024^2: transformer depths
              1, 2, 10), adam_bf16_fused one launch per step over the 986
              groups; step 5 runs
              under the trainer's torch.profiler (its kernels by category,
              launches and the device's busy share);
              sdxl_sample: the sample CLI at the file's concept (24 steps,
              cfg 7, 1024^2, seed 114514), one image per method and the
              concept's DPM++(2M) again with equal PNG bytes, splash_fwd
              1,680 per image; the DDIM loop with the kernels against the
              plain attention path at the sample phase's bounds; one UNet
              call's device and host ms and CUDA operations, the 1024^2
              decode's and both towers' device ms.
              Prints each phase's seconds. Then the kernels in SDXL's forms
              (head dim 64, the kernels' DP = 64 instances): splash fwd, dq,
              dkv at (1,10,4096,64), (1,20,1024,64), the ragged
              (1,10,4032,64) and the lora run's bucket shapes as in phase 2;
              splash_fwd in sampling's form at (2,10,4096,64) and
              (2,20,1024,64); adam_bf16_fused over lora_sdxl's 986 groups of
              fp32 factors at SDXL widths in one launch, bit for bit, with the
              optimizer step's host time.
15. lora_prodigy -- (after lora) configs/lora.yaml through the train CLI with
              optimizer prodigyopt.Prodigy at lr 1.0, sampling off: 4 steps
              with a checkpoint at 2, then a run resumed from it that must
              end on the same checkpoint and sidecar bytes and losses
              (Prodigy's params0, moments and 0-dim estim_lr in the
              sidecar); splash launches as the buckets give them, no
              optimizer kernel.
16. families -- (last) the train phase's step under each optimizer family:
              adamw (the reference), adam, lion, adafactor (blocks from the
              JAX trainer's default slabs), prodigyopt.Prodigy and
              dadaptation.DAdaptAdam (lr 1.0), sgd (lr 1e-3), 2 warm-up and
              2 timed steps each: splash 10 launches per step each,
              adam_bf16_fused 1 under adam and adamw and 0 under the others,
              losses finite, masters moved; Prodigy's and D-Adapt's
              estim_lr above d0 (up to 23 more untimed steps); the first
              update of three SD1.5 leaves on the card against the same
              chain on the CPU (bit for bit for elementwise chains, 1e-6 of
              the largest entry for the Adam kernel, 1e-5 with reductions).
              Prints steps/s, the optimizer's device ms (a torch.profiler
              trace of one update_and_apply) and host ms per step beside
              AdamW's, its CUDA launches, peak memory.
17. sd3    -- (after the SDXL phases, whose directory it deletes) SD3-Medium
              at its published widths, random weights from --seed, frozen
              parts in bf16, no tokenizer package needed:
              (a) splash fwd, dq, dkv at (2,24,4250,64) and (2,24,1178,64),
              the joint attention's ragged lengths at 1024^2 and 512^2, and
              (2,24,4096,64), SD3.5's attn2, as in phase 2 (same bounds);
              (b) the cached step at 1024^2, batch 2 (latents
              (2,16,128,128), conds (2,154,4096), pooled (2,2048)), full
              MMDiT under the JAX package's default AdamW (fp32 masters and
              moments: adam_bf16_fused's xla mode), 2 warm-up and --steps
              timed steps: each splash kernel 24 launches per step,
              adam_bf16_fused once (over the 6 param groups); one MMDiT forward
              against the plain attention path within the check phase's
              bound;
              (c) the triple-encoder step at batch 1: CLIP-L and CLIP-G
              (projected) and T5-XXL v1.1's encoder frozen, fed ids drawn
              from the generator, CFG dropout 'eos', the MMDiT as in (b):
              2 warm-up and 3 timed steps, the same launches;
              (d) an SD3-Medium diffusers directory without text_encoder_3/
              written here: the train CLI with optim_target lora_sd3 (285
              groups) uncached at 1024^2, batch 1, 3 steps ending on a
              checkpoint (24 launches of each splash kernel and 1 of
              adam_bf16_fused per step), then the sample CLI with that
              checkpoint: one 1024^2 image by flow_euler at 28 steps, 672
              splash_fwd and nothing else; then adam_bf16_fused's xla mode
              in one grouped launch over the MMDiT's 682 fp32 leaves, bit
              for bit against its plain chain.
18. single_file -- (after sd3, whose directory it deletes) single-file
              checkpoints and the checkpoint toolchain:
              (a) the trainer phase's SD1.5 directory as a training-layout
              file published by the port's ckpt_tool prune --text-encoder
              --df-vae in fp32; load_components of the file (the bundled v1
              YAML) gives every tensor of the directory; the train CLI from
              the file, 2 cached steps at 512^2, batch 8 (10 launches of
              each splash kernel per step); the sample CLI from the file,
              one 512^2 image at the shipped concept: 280 splash_fwd only,
              the PNG equal to the directory's;
              (b) SD2.1-768-v at its published widths from --seed (the
              UNet with heads 5, 10, 20, 20 and linear projections, context
              1024; OpenCLIP-H with 24 resblocks; SD's VAE) as one fp32
              file with Stability AI's v2-inference-v YAML: load_components
              with that YAML and schedule.prediction_type v gives
              UNetConfig.sd21 and a 23-layer tower; the train CLI uncached
              at 768^2, batch 2, the default AdamW (fp32 masters and
              moments: the xla mode), v-prediction, 2 warm-up and --steps
              timed steps ending on a checkpoint: per step 5 launches of
              each splash kernel at (2,5,9216,64) and at (2,10,2304,64)
              (counted by form), adam_bf16_fused once; losses
              finite, masters moved; the checkpoint with the tower bundled
              through ckpt_tool prune --arch sd2 --text-encoder at fp32 and
              fp16 reloads as the masters bit for bit and their fp16 cast;
              one 768^2 image by DDIM at 28 steps, cfg 7.5, through
              sampler.sample_images (140 splash_fwd at each form);
              (c) splash fwd, dq, dkv at (2,5,9216,64), (2,10,2304,64),
              (2,5,4096,64), (2,10,1024,64) as in phase 2 (same bounds);
              (d) the extract_lora CLI between (b)'s pruned file and the
              base (lora_no-te.yaml, rank 16, fp32), its SVDs on the card,
              each timed; three leaves' (alpha/rank) up @ down within 1e-4
              of the delta's largest entry of a float64 CPU SVD's rank-16
              truncation, the Frobenius errors within 1e-3 relative.

The optim phase also runs both grouped kernels with fp32 gradients, the mean
that gradient accumulation hands them, at the same bounds.

Output: the build's register/spill report, one line per phase, then (before
the last line) a {"kernels": [...]} JSON line and the card's name and power
limit, and last {"ok": true, "device": {"platform": "gpu", ...}}. A full record
goes to chiprun_out/chip_smoke.json. Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from scal_sdt_tpu_torch.cli import gen_class_imgs as gen_class_imgs_cli
from scal_sdt_tpu_torch.cli import cache as cache_cli
from scal_sdt_tpu_torch.cli import sample as sample_cli
from scal_sdt_tpu_torch.cli import train as train_cli
from scal_sdt_tpu_torch.cli.cache import assemble_cache, build_local_shard
from scal_sdt_tpu_torch.conf import (CONFIGS_DIR, Config, default, load_optim_target,
                                     load_with_defaults, merge)
from scal_sdt_tpu_torch.convert.loader import (LoadedModels, cached_snapshot, load_components,
                                              load_ldm_checkpoint)
from scal_sdt_tpu_torch.data.datasets import LatentCache
from scal_sdt_tpu_torch.data.pipeline import DataPipeline, get_dataset, get_sampler, to_device
from scal_sdt_tpu_torch.diffusion import sampler
from scal_sdt_tpu_torch.diffusion.flow import FlowSchedule
from scal_sdt_tpu_torch.models.clip import (CLIPTextConfig, clip_param_shapes, clip_text_apply,
                                            encode_sdxl, init_clip_params)
from scal_sdt_tpu_torch.models.mmdit import (POS_EMBED_KEY, MMDiTConfig, init_mmdit_params,
                                             mmdit_apply, mmdit_param_shapes)
from scal_sdt_tpu_torch.models.t5 import T5Config, init_t5_params
from scal_sdt_tpu_torch.models.unet import (UNetConfig, init_unet_params, unet_apply,
                                            unet_param_shapes)
from scal_sdt_tpu_torch.models.vae import (VAEConfig, decoder_apply, encoder_apply,
                                           init_vae_params, sample_latents)
from scal_sdt_tpu_torch.native import image as native_image
from scal_sdt_tpu_torch.ops import _build, adam8_fused, adam_bf16_fused, attention, ema_fused, splash
from scal_sdt_tpu_torch.text.bpe import CLIPBPETokenizer, bytes_to_unicode
from scal_sdt_tpu_torch.training.checkpoint import CheckpointManager
from scal_sdt_tpu_torch.training.ema import one_minus_decay
from scal_sdt_tpu_torch.training.lora import lora_factor_shapes
from scal_sdt_tpu_torch.training.optim_targets import (COMPONENT_PREFIX, group_labels,
                                                       resolve_optim_target)
from scal_sdt_tpu_torch.training.optimizers import AccumulationState, GradientAccumulation, build_optimizer
from scal_sdt_tpu_torch.training.quantized import Adam8bit, bias_corrections
from scal_sdt_tpu_torch.training.sample_callback import SampleCallback
from scal_sdt_tpu_torch.training.step import (StepSpec, compute_loss, draw, init_train_state,
                                              loss_and_grads, make_train_step)
from scal_sdt_tpu_torch.training import tuner
from scal_sdt_tpu_torch.training.trainer import Trainer
from scal_sdt_tpu_torch.utils import flops
from scal_sdt_tpu_torch.utils.state import (load_metadata, load_state_dict, save_json_metadata,
                                           save_state_dict)

# H100 SXM data-sheet peaks (dense bf16 tensor cores, fp32 on the CUDA
# cores, HBM3), at 700 W.
PEAK_BF16_FLOPS = flops.GPU_PEAK_FLOPS["NVIDIA H100 80GB HBM3"]
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
EXP_PER_CLOCK_PER_SM = 16  # MUFU.EX2 results per clock per SM (sm_90)
MAIN_SHAPES = [(8, 8, 4096, 40), (8, 8, 1024, 80)]
ARB_SHAPE = (1, 8, 1344, 40)
CALLS_PER_STEP = 10      # 5 self-attentions at L=4096 + 5 at L=1024
SD15_LEAVES, SD15_INT8_LEAVES = 686, 227
INT8_SHAPES = [(1280, 23040), (320, 2880)]    # (1280,2560,3,3) and (320,320,3,3) views
ADAM_CASES = [  # (shape, moment dtype, nu SR, xla): AdamW's largest leaf; an int8-path
    # small leaf; the largest leaf under the default AdamW (fp32 moments, XLA's rounding)
    ((1280, 23040), torch.bfloat16, True, False), ((320,), torch.float32, False, False),
    ((1280, 23040), torch.float32, False, True)]
# fp32 operations per element (dequantize 2, moments 7, step 5, requantize
# 2 x 6; fused Adam: moments 7, step 5; the grouped epilogue: decay multiply
# and add, schedule multiply, master add) against the CUDA-core fp32 peak
ADAM8_OPS, ADAM_OPS, EPILOGUE_OPS = 26, 12, 4
B1, B2, EPS = 0.9, 0.999, 1e-8
GROUP_WD, GROUP_STEP_SIZE = 1e-2, -2e-6    # the grouped cases' decay and -lr * schedule
# adam_bf16_fused launches per optimizer step of a run whose Adam groups share
# one launch signature (betas, eps, rounding, dtypes), as every run here does:
# one launch over every group's leaves (training/optimizers.py MultiTransform)
ADAM_PER_STEP = 1
MASTER_FLIPS = 1e-3      # int8 grouped masters: one bf16 ulp apart in under this share
PAYLOAD_FLIPS = 1e-3     # int8 payloads: at most 1 apart in under this share
OPT_TOL = 1e-6           # optimizer step, scales: relative to the tensor's largest
FWD_TOL, GRAD_TOL = 5e-3, 1.5e-2
LSE_TOL = 1e-4           # splash_fwd's lse, max-abs in natural-log units
DELTA_TOL = 1e-5         # delta = rowsum(dO * O), relative to its largest entry
SDPA_BWD = ("SDPA backward (torch.autograd.grad of F.scaled_dot_product_attention): "
            "dq, dk and dv together")
CHECK_TOL = 5e-2         # UNet output, kernel path vs plain path, relative
OUT_DIR = Path("chiprun_out")
DEVICE = "cuda"           # of the uncached and cache phases
RESOLUTION = 512         # the uncached and cache phases' image size
UNCACHED_IMAGES = 24     # PNG files of the uncached and cache phases
IMAGE_SIZES = [(720, 576), (576, 720)]   # (w, h): resized and cropped to 512^2
NUM_WORKERS = 6          # the DataPipeline's decode threads (the card's host has 8 cores)
VOCAB_MERGES = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("o", "f</w>"), ("p", "h"),
                ("ph", "o"), ("pho", "t"), ("phot", "o</w>"), ("c", "at</w>"), ("n", "u")]

# name -> (port source, the JAX package's entry to the TPU kernel, the Pallas
# kernel it reaches inside jax/experimental/pallas/ops/tpu/splash_attention/)
KERNELS = {
    "splash_fwd": ("scal_sdt_tpu_torch/ops/csrc/splash_fwd.cu", "scal_sdt_tpu/ops/splash.py:88",
                   "splash_attention_kernel.py:1137"),
    "splash_dq": ("scal_sdt_tpu_torch/ops/csrc/splash_bwd.cu", "scal_sdt_tpu/ops/splash.py:88",
                  "splash_attention_kernel.py:1635"),
    "splash_dkv": ("scal_sdt_tpu_torch/ops/csrc/splash_bwd.cu", "scal_sdt_tpu/ops/splash.py:88",
                   "splash_attention_kernel.py:2196"),
    "adam8_fused": ("scal_sdt_tpu_torch/ops/csrc/adam8_fused.cu",
                    "scal_sdt_tpu/ops/adam8_fused.py:92", "scal_sdt_tpu/ops/adam8_fused.py:127"),
    "adam_bf16_fused": ("scal_sdt_tpu_torch/ops/csrc/adam_bf16_fused.cu",
                        "lab/micro_bf16_update.py:62", "lab/micro_bf16_update.py:86"),
    # the port's own kernel: JAX computes the EMA in XLA, no Pallas kernel
    "ema_fused": ("scal_sdt_tpu_torch/ops/csrc/ema_fused.cu",
                  "scal_sdt_tpu/training/ema.py:141", "none (ema_update runs in XLA)"),
}
SPLASH = ("splash_fwd", "splash_dq", "splash_dkv")
PHASES = ("train", "train_int8", "families", "uncached", "cache", "trainer", "ema",
          "sample", "lora", "lora_prodigy", "dreambooth", "sdxl_cache", "sdxl_lora",
          "sdxl_sample", "sd3_cached", "sd3_triple", "sd3_cli",
          "single_file", "parallel", "tuner", "tuner_world",
          "custom_diffusion")   # the phases that run a main path
COUNTERS = (splash, adam8_fused, adam_bf16_fused, ema_fused)


def reset_launches() -> None:
    for mod in COUNTERS:
        mod.reset_launches()


def read_launches() -> dict[str, int]:
    return {k: v for mod in COUNTERS for k, v in mod.launches.items()}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


_START = time.perf_counter()


def log(msg: str) -> None:
    """Print a progress line with the seconds since the script started."""
    print(f"{msg} [{time.perf_counter() - _START:.0f} s]", flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, hold_cycles: int = 200_000_000) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events, with the
    calls queued behind a spin kernel (~0.1 s at 2 GHz): the device then runs
    them back to back, so the host's time to issue them does not count."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(hold_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kernel: str, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time per call of fn() of the CUDA kernels whose names
    contain ``kernel``, from a torch.profiler trace of ``iters`` calls: the
    host's time around a launch (the gradient addresses' upload) does not
    count."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    # the trace may miss a launch now and then: the mean is over those it holds
    check(2 * len(us) >= iters, f"{len(us)} {kernel} kernels traced in {iters} calls")
    return sum(us) / len(us) / 1e3


def staged_device_ms(run, staging, iters: int = 10, warmup: int = 2,
                     hold_cycles: int = 20_000_000) -> float:
    """Mean device time of the one kernel ``run()`` launches after staging
    its arguments through ``staging`` (an ``adam_bf16_fused.GradPointers``),
    by CUDA events around that kernel alone: a spin kernel (~10 ms) holds the
    stream while the host enqueues it, so the host's work around the launch
    does not count. Late in the smoke a torch.profiler trace may hold none
    of the ops/ kernels (``kernel_device_ms``); this needs no trace."""
    for _ in range(warmup):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    upload = staging.upload

    def timed_upload(*args, **kwargs):
        address = upload(*args, **kwargs)
        torch.cuda._sleep(hold_cycles)
        start.record()
        return address

    total = 0.0
    staging.upload = timed_upload
    try:
        for _ in range(iters):
            run()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
    finally:
        del staging.upload
    return total / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_abs(a, b) / float(b.detach().float().abs().max())


def splash_work(b: int, h: int, lq: int, lk: int, d: int) -> dict[str, tuple[int, int, int]]:
    """(tensor-core flops, bytes, exponentials) each splash kernel must spend.
    Flops count the matrix products: fwd q k^T and P v; dq also recomputes S
    and forms dP and dS k; dkv S^T, dP^T, P^T dO, dS^T q. Bytes read each
    input once and write each output once. Each kernel takes one exponential
    per score: B*H*Lq*Lk."""
    bh, e = b * h, 2  # bf16 bytes
    tq, tk, row = bh * lq * d * e, bh * lk * d * e, bh * lq * 4  # q-like, k-like, fp32 row
    exps = bh * lq * lk
    return {
        "splash_fwd": (4 * bh * lq * lk * d, tq + 2 * tk + tq + row, exps),          # q k v -> o lse
        "splash_dq": (6 * bh * lq * lk * d, 3 * tq + 2 * tk + row + row + tq, exps),  # q o dO k v lse -> delta dq
        "splash_dkv": (8 * bh * lq * lk * d, 2 * tq + 2 * tk + 2 * row + 2 * tk, exps),  # q dO k v lse delta -> dk dv
    }


def bounds_ms(b: int, h: int, lq: int, lk: int, d: int, sms: int,
              sm_clock_hz: float) -> dict[str, tuple[float, str]]:
    """Least time per splash kernel, and what sets it: the largest of bytes
    over the HBM rate, flops over the bf16 tensor-core peak, and
    exponentials over the exponential unit's rate (EXP_PER_CLOCK_PER_SM on
    each of ``sms`` SMs at ``sm_clock_hz``)."""
    out = {}
    for name, (flops, nbytes, exps) in splash_work(b, h, lq, lk, d).items():
        times = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
                 "bytes": nbytes / PEAK_HBM_BYTES_PER_S * 1e3,
                 "exp": exps / (sms * EXP_PER_CLOCK_PER_SM * sm_clock_hz) * 1e3}
        by = max(times, key=times.get)
        out[name] = (times[by], by)
    return out


def exp_rate() -> tuple[int, float]:
    """The card's SM count and its maximum SM clock in Hz (nvidia-smi)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return sms, float(mhz.split()[0]) * 1e6


def head_views(shape, gen: torch.Generator) -> torch.Tensor:
    """A (B, H, L, D) bf16 head-split view of a (B, L, H*D) tensor, the layout
    ops/attention.py hands the kernels."""
    b, h, l, d = shape
    x = torch.randn(b, l, h * d, generator=gen, device="cuda").to(torch.bfloat16)
    return x.view(b, l, h, d).transpose(1, 2)


def kernel_phase(shape, gen: torch.Generator, rate: tuple[int, float]) -> dict:
    b, h, l, d = shape
    scale = d ** -0.5
    q, k, v, do = (head_views(shape, gen) for _ in range(4))
    qs = splash._prescale(q, scale)

    o, lse = splash.splash_fwd(qs, k, v)
    o2, lse2 = splash.splash_fwd(qs, k, v)
    o_ref, lse_ref = splash.splash_fwd_reference(qs, k, v)
    dq, delta = splash.splash_dq(qs, k, v, o, do, lse)
    dq_ref, delta_ref = splash.splash_dq_reference(qs, k, v, o, do, lse)
    dk, dv = splash.splash_dkv(qs, k, v, do, lse, delta)
    dk_ref, dv_ref = splash.splash_dkv_reference(qs, k, v, do, lse, delta)
    # a second launch of each kernel gives the same bits (one CTA owns each
    # output row, no atomics): resumed runs depend on it
    dq2, delta2 = splash.splash_dq(qs, k, v, o, do, lse)
    dk2, dv2 = splash.splash_dkv(qs, k, v, do, lse, delta2)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in
                    ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
    fwd_same_bits = torch.equal(o, o2) and torch.equal(lse, lse2)
    del dq2, delta2, dk2, dv2, o2, lse2
    res = {"shape": list(shape), "bwd_same_bits": same_bits, "fwd_same_bits": fwd_same_bits,
           "err": {"splash_fwd": max_abs(o, o_ref), "lse": max_abs(lse, lse_ref),
                   "delta": max_abs(delta, delta_ref), "delta_rel": rel_err(delta, delta_ref),
                   "splash_dq": max_abs(dq, dq_ref), "splash_dq_rel": rel_err(dq, dq_ref),
                   "splash_dkv": max(max_abs(dk, dk_ref), max_abs(dv, dv_ref)),
                   "splash_dkv_rel": max(rel_err(dk, dk_ref), rel_err(dv, dv_ref))}}
    del o_ref, lse_ref, dq_ref, delta_ref, dk_ref, dv_ref
    e = res["err"]
    check(e["splash_fwd"] <= FWD_TOL, f"splash_fwd disagrees at {shape}: {e['splash_fwd']}")
    check(e["lse"] <= LSE_TOL, f"splash_fwd lse disagrees at {shape}: {e['lse']}")
    check(fwd_same_bits, f"splash_fwd gives other bits on a second launch at {shape}")
    check(e["splash_dq_rel"] <= GRAD_TOL, f"splash_dq disagrees at {shape}: {e['splash_dq_rel']}")
    check(e["delta_rel"] <= DELTA_TOL, f"splash_dq delta disagrees at {shape}: {e['delta_rel']}")
    check(e["splash_dkv_rel"] <= GRAD_TOL,
          f"splash_dkv disagrees at {shape}: {e['splash_dkv_rel']}")
    check(same_bits, f"splash_dq / splash_dkv give other bits on a second launch at {shape}")

    # The autograd Function end to end against autograd of the plain version.
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = splash.splash_attention(*leaves, scale)
    want = splash.splash_attention_reference(*refs, scale)
    out.backward(do)
    want.backward(do)
    res["autograd_err"] = {"out": max_abs(out, want),
                           **{f"d{n}_rel": rel_err(a.grad, r.grad)
                              for n, a, r in zip("qkv", leaves, refs)}}
    del out, want, leaves, refs
    check(res["autograd_err"]["out"] <= FWD_TOL, f"splash_attention forward at {shape}")
    check(all(res["autograd_err"][f"d{n}_rel"] <= GRAD_TOL for n in "qkv"),
          f"splash_attention gradients at {shape}: {res['autograd_err']}")

    res["ms"] = {
        "splash_fwd": time_ms(lambda: splash.splash_fwd(qs, k, v)),
        "splash_dq": time_ms(lambda: splash.splash_dq(qs, k, v, o, do, lse)),
        "splash_dkv": time_ms(lambda: splash.splash_dkv(qs, k, v, do, lse, delta)),
    }
    # the kernels' device time alone, queued behind a spin kernel (at the
    # short forms the wrappers' host time bounds "ms")
    res["device_ms"] = {
        "splash_fwd": device_ms(lambda: splash.splash_fwd(qs, k, v)),
        "splash_dq": device_ms(lambda: splash.splash_dq(qs, k, v, o, do, lse)),
        "splash_dkv": device_ms(lambda: splash.splash_dkv(qs, k, v, do, lse, delta)),
    }
    res["plain_ms"] = {
        "splash_fwd": time_ms(lambda: splash.splash_fwd_reference(qs, k, v), iters=3),
        "splash_dq": time_ms(lambda: splash.splash_dq_reference(qs, k, v, o, do, lse),
                             iters=3),
        "splash_dkv": time_ms(lambda: splash.splash_dkv_reference(qs, k, v, do, lse, delta),
                              iters=3),
    }
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    res["sdpa_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    res["fwd_over_sdpa"] = res["ms"]["splash_fwd"] / res["sdpa_fwd_ms"]
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    # at L = 1024 the host work of one autograd.grad call outlasts its
    # kernels, so plain CUDA events would time the host
    res["sdpa_bwd_ms"] = device_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True))
    del sdpa_out

    def bwd_pair():
        splash.splash_dkv(qs, k, v, do, lse, splash.splash_dq(qs, k, v, o, do, lse)[1])

    res["bwd_pair_ms"] = time_ms(bwd_pair, iters=50, warmup=5)
    res["bwd_pair_over_sdpa"] = res["bwd_pair_ms"] / res["sdpa_bwd_ms"]
    res["bound"] = {n: list(v) for n, v in bounds_ms(b, h, l, l, d, *rate).items()}
    del q, k, v, do, qs, o, lse, dq, delta, dk, dv
    torch.cuda.empty_cache()
    return res


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms, and what sets it: bytes over the HBM rate, or fp32
    operations over the CUDA-core peak."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def adam8_case(shape, gen: torch.Generator) -> dict:
    """adam8_fused against its plain version on the second step of a state
    the plain version quantized on the first."""
    lead, minor = shape
    nb = -(-minor // adam8_fused.BLOCK)
    grad = lambda: (torch.randn(shape, generator=gen, device="cuda") * 1e-3).bfloat16()
    state = [torch.zeros(lead, nb * adam8_fused.BLOCK, dtype=torch.int8, device="cuda"),
             torch.zeros(lead, nb, device="cuda")]
    state += [t.clone() for t in state]
    hp = dict(b1=B1, b2=B2, eps=EPS)
    inv = lambda t: tuple(1.0 / (1.0 - b ** t) for b in (B1, B2))
    adam8_fused.adam8_fused_update_reference(grad(), *state, *inv(1), **hp)
    g = grad()
    # both sides update their own copy of the state in place
    got = adam8_fused.adam8_fused_update(g, *(t.clone() for t in state), *inv(2), **hp)
    want = adam8_fused.adam8_fused_update_reference(g, *(t.clone() for t in state), *inv(2),
                                                    **hp)
    torch.cuda.synchronize()
    err = {"out": max_abs(got[0], want[0]), "out_rel": rel_err(got[0], want[0])}
    for i, name in ((1, "mu_q"), (3, "nu_q")):
        d = (got[i].int() - want[i].int()).abs()
        err[name + "_max"] = int(d.max())
        err[name + "_share"] = float((d > 0).float().mean())
        check(err[name + "_max"] <= 1 and err[name + "_share"] < PAYLOAD_FLIPS,
              f"adam8_fused {name} at {shape}: {err}")
        check(not got[i][:, minor:].any(), f"adam8_fused {name} padded tail not zero at {shape}")
    err["scales_rel"] = max(rel_err(got[2], want[2]), rel_err(got[4], want[4]))
    check(err["out_rel"] <= OPT_TOL and err["scales_rel"] <= OPT_TOL,
          f"adam8_fused disagrees at {shape}: {err}")
    del got, want
    n, nq = lead * minor, lead * nb * adam8_fused.BLOCK
    nbytes = 2 * n * g.element_size() + 2 * 2 * nq + 2 * 2 * lead * nb * 4
    return {"shape": list(shape), "err": err,
            "ms": time_ms(lambda: adam8_fused.adam8_fused_update(g, *state, *inv(2), **hp)),
            "plain_ms": time_ms(lambda: adam8_fused.adam8_fused_update_reference(
                g, *state, *inv(2), **hp), iters=3),
            "bytes": nbytes, "bound": list(bound(nbytes, ADAM8_OPS * nq)), "library_ms": None}


def adam_case(shape, m_dtype: torch.dtype, sr: bool, xla: bool, gen: torch.Generator) -> dict:
    """adam_bf16_fused against its plain version: AdamW's form (divide, fp32
    step, SR nu) for bf16 moments, the int8 path's (reciprocal, step in the
    gradient's dtype) for fp32 moments, and with ``xla`` the default AdamW's
    (fp32 moments, XLA's rounding of plain scale_by_adam; the step bit for
    bit too)."""
    g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).bfloat16()
    mu = (torch.randn(shape, generator=gen, device="cuda") * 1e-4).to(m_dtype)
    nu = (torch.rand(shape, generator=gen, device="cuda") * 1e-7).to(m_dtype)
    t = 3
    bc = tuple(1.0 - b ** t for b in (B1, B2))
    kw = dict(b1=B1, b2=B2, eps=EPS, out_dtype=torch.float32 if sr or xla else g.dtype,
              recip_bc=not (sr or xla), **({"sr_step": t, "sr_salt": 0x5EED} if sr else {}))
    if xla:
        kw["xla"] = True
    # both sides update their own copy of the moments in place
    got = adam_bf16_fused.adam_bf16_fused_update(g, mu.clone(), nu.clone(), bc, **kw)
    want = adam_bf16_fused.adam_bf16_fused_update_reference(g, mu.clone(), nu.clone(), bc, **kw)
    torch.cuda.synchronize()
    err = {"out": max_abs(got[0], want[0]), "out_rel": rel_err(got[0], want[0]),
           "mu_equal": torch.equal(got[1], want[1]), "nu_equal": torch.equal(got[2], want[2])}
    check(err["mu_equal"] and err["nu_equal"] and err["out_rel"] <= (0.0 if xla else OPT_TOL),
          f"adam_bf16_fused disagrees at {shape} {m_dtype} xla={xla}: {err}")
    del got, want
    n = g.numel()
    out_size = torch.empty((), dtype=kw["out_dtype"]).element_size()
    nbytes = n * (g.element_size() + 4 * mu.element_size() + out_size)
    res = {"shape": list(shape), "moments": str(m_dtype), "sr": sr, "xla": xla, "err": err,
           "ms": time_ms(lambda: adam_bf16_fused.adam_bf16_fused_update(g, mu, nu, bc, **kw)),
           "plain_ms": time_ms(lambda: adam_bf16_fused.adam_bf16_fused_update_reference(
               g, mu, nu, bc, **kw), iters=3),
           "bytes": nbytes, "bound": list(bound(nbytes, ADAM_OPS * n)), "library_ms": None}
    # nearest library call, not the same function: torch's fused AdamW over
    # bf16 param, gradient and moments of the same leaf
    p, m2, v2 = g.clone(), mu.bfloat16(), nu.bfloat16().abs()
    steps = [torch.tensor(float(t), device="cuda")]
    res["library_ms"] = time_ms(lambda: torch._fused_adamw_(
        [p], [g], [m2], [v2], [], steps, lr=1e-6, beta1=B1, beta2=B2, weight_decay=1e-2,
        eps=EPS, amsgrad=False, maximize=False))
    res["library"] = "torch._fused_adamw_ (bf16 moments; nearest call, not the same function)"
    return res


def sd15_leaves() -> tuple[list[str], list[tuple[int, ...]]]:
    """The 686 SD1.5 UNet leaves: keys (as the trainer names them) and shapes."""
    shapes = unet_param_shapes(UNetConfig.sd15())
    keys = sorted(shapes)
    check(len(keys) == SD15_LEAVES, f"{len(keys)} SD1.5 leaves")
    return [f"unet.{k}" for k in keys], [tuple(shapes[k]) for k in keys]


def rand(shape, gen: torch.Generator, scale: float, dtype=torch.bfloat16,
         positive: bool = False) -> torch.Tensor:
    x = (torch.rand if positive else torch.randn)(shape, generator=gen, device="cuda")
    return (x * scale).to(dtype)


def clones(ts):
    return [t.clone() for t in ts]


def group_bytes(table, g_size: int = 2) -> int:
    """Bytes the grouped launch over ``table`` must move: the gradient read,
    each moment (payloads and scales) and master read and written."""
    if isinstance(table, adam8_fused.Adam8Table):
        per_leaf = [p.numel() * (g_size + 2 * p.element_size()) + 2 * sum(
            t.numel() * t.element_size() for t in st) for p, st in zip(table.params, table.state)]
    else:
        per_leaf = [p.numel() * (g_size + 2 * (p.element_size() + m.element_size()
                                               + v.element_size()))
                    for p, m, v in zip(table.params, table.mu, table.nu)]
    return sum(per_leaf)


def group_record(got, want, run, plain, kernel: str, ops: int, err: dict,
                 g_size: int = 2, traced: bool = True) -> dict:
    """Times, bytes and bound of a grouped launch ``run()`` over ``got``
    (device time of ``kernel`` from a trace, or with ``traced`` false the
    call's time by CUDA events, which also holds the host's upload of the
    gradient addresses, as "call_ms" always does), its plain chain
    ``plain()`` over ``want``; ``g_size``: bytes per gradient element."""
    n = sum(p.numel() for p in got.params)
    nbytes = group_bytes(got, g_size)
    call_ms = time_ms(run)
    return {"leaves": len(got.params), "elements": n, "chunks": len(got.chunks), "err": err,
            "ms": kernel_device_ms(run, kernel) if traced else call_ms, "call_ms": call_ms,
            "plain_ms": time_ms(plain, iters=1, warmup=0),
            "bytes": nbytes, "bound": list(bound(nbytes, ops * n)), "library_ms": None}


def master_flips(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(largest difference in ulps of the larger magnitude, share of elements
    that differ) of two bf16 masters."""
    a, b = got.float(), want.float()
    ulp = torch.finfo(got.dtype).eps * torch.maximum(a.abs(), b.abs()).clamp_min(1e-38)
    d = (a - b).abs()
    return float((d / ulp).max()), float((d > 0).float().mean())


def adamw_group_case(gen: torch.Generator, keys, shapes,
                     g_dtype: torch.dtype = torch.bfloat16, xla: bool = False,
                     traced: bool = True) -> dict:
    """AdamW's grouped adam_bf16_fused over every SD1.5 leaf (bf16 masters
    and moments, nu by SR, decay and schedule, master SR) against its plain
    chain leaf by leaf: masters and moments bit for bit. ``g_dtype``: the
    gradients' (fp32: gradient accumulation's mean). ``xla``: the default
    AdamW's form instead (fp32 masters and moments, XLA's rounding)."""
    m_dtype = torch.float32 if xla else torch.bfloat16
    params = [rand(s, gen, 2e-2, m_dtype) for s in shapes]
    mu = [rand(s, gen, 1e-4, m_dtype) for s in shapes]
    nu = [rand(s, gen, 1e-7, m_dtype, positive=True) for s in shapes]
    grads = [rand(s, gen, 1e-3, g_dtype) for s in shapes]
    count = 3
    steps = [adam_bf16_fused.GroupStep(bias_corrections(B1, B2, count), count, GROUP_WD,
                                       GROUP_STEP_SIZE)]
    kw = dict(b1=B1, b2=B2, eps=EPS, recip_bc=False, step=count - 1,
              update_dtype=torch.float32, xla=xla)
    got = adam_bf16_fused.build_adam_table([keys], clones(params), clones(mu), clones(nu))
    adam_bf16_fused.adam_bf16_fused_apply(got, grads, steps, **kw)
    want = adam_bf16_fused.build_adam_table([keys], params, mu, nu)  # updated in place
    adam_bf16_fused.adam_bf16_fused_apply_reference(want, grads, steps, **kw)
    torch.cuda.synchronize()
    err = {what: all(torch.equal(a, b) for a, b in zip(getattr(got, what), getattr(want, what)))
           for what in ("params", "mu", "nu")}
    err["out"] = max(max_abs(a, b) for a, b in zip(got.params, want.params))
    check(err["params"] and err["mu"] and err["nu"],
          f"grouped adam_bf16_fused (AdamW) disagrees with its plain chain: {err}")
    res = group_record(got, want,
                       lambda: adam_bf16_fused.adam_bf16_fused_apply(got, grads, steps, **kw),
                       lambda: adam_bf16_fused.adam_bf16_fused_apply_reference(want, grads,
                                                                               steps, **kw),
                       "adam_bf16_group", ADAM_OPS + EPILOGUE_OPS, err, grads[0].element_size(),
                       traced)
    if g_dtype != torch.bfloat16 or xla:   # torch's fused AdamW: gradients of the params' dtype
        return res
    # nearest library call, not the same function: torch's fused AdamW over
    # the same 686 bf16 params, gradients and moments
    counts = [torch.tensor(float(count), device=grads[0].device) for _ in keys]
    res["library_ms"] = time_ms(lambda: torch._fused_adamw_(
        want.params, grads, want.mu, want.nu, [], counts, lr=1e-6, beta1=B1, beta2=B2,
        weight_decay=GROUP_WD, eps=EPS, amsgrad=False, maximize=False))
    res["library"] = ("torch._fused_adamw_ over the same 686 bf16 lists (nearest call, not "
                      "the same function)")
    return res


def adamw8bit_group_case(gen: torch.Generator, keys, shapes,
                         g_dtype: torch.dtype = torch.bfloat16) -> dict:
    """AdamW8bit's two grouped launches over every SD1.5 leaf (bf16 masters):
    adam8_fused over the int8 leaves (payloads at most 1 apart in under 1e-3
    of them, scales within 1e-6 relative, masters at most one ulp apart in
    under 1e-3 of them) and adam_bf16_fused over the fp32-moment leaves (bit
    for bit), from a state that one plain step has filled; gradients of
    ``g_dtype`` (fp32: gradient accumulation's mean, the update fp32 too)."""
    params = {k: rand(s, gen, 2e-2) for k, s in zip(keys, shapes)}
    state = Adam8bit(B1, B2, EPS).init(params)
    k8 = [k for k in keys if k in state.mu_s]
    k32 = [k for k in keys if k not in state.mu_s]
    check(len(k8) == SD15_INT8_LEAVES, f"{len(k8)} int8 leaves")

    def tables(ps, st):
        return (adam8_fused.build_adam8_table(
                    k8, [ps[k] for k in k8],
                    [(st.mu_q[k], st.mu_s[k], st.nu_q[k], st.nu_s[k]) for k in k8]),
                adam_bf16_fused.build_adam_table([k32], [ps[k] for k in k32],
                                                 [st.mu_q[k] for k in k32],
                                                 [st.nu_q[k] for k in k32]))

    def step_fns(t8, t32, grads, count, plain):
        bc = bias_corrections(B1, B2, count)
        inv = [float(1 / b) for b in bc]
        hp = dict(b1=B1, b2=B2, eps=EPS, step=count - 1)
        f8 = adam8_fused.adam8_fused_apply_reference if plain else adam8_fused.adam8_fused_apply
        f32 = (adam_bf16_fused.adam_bf16_fused_apply_reference if plain
               else adam_bf16_fused.adam_bf16_fused_apply)
        g8, g32 = [grads[k] for k in t8.keys], [grads[k] for k in t32.keys[0]]
        steps = [adam_bf16_fused.GroupStep(bc, count, GROUP_WD, GROUP_STEP_SIZE)]
        return (lambda: f8(t8, g8, *inv, weight_decay=GROUP_WD, step_size=GROUP_STEP_SIZE, **hp),
                lambda: f32(t32, g32, steps, recip_bc=True, **hp))

    want8, want32 = tables(params, state)
    for fn in step_fns(want8, want32, {k: rand(s, gen, 1e-3, g_dtype)
                                       for k, s in zip(keys, shapes)}, 1, plain=True):
        fn()
    kparams = {k: v.clone() for k, v in params.items()}
    kstate = dataclasses.replace(state, **{f: {k: v.clone() for k, v in getattr(state, f).items()}
                                           for f in ("mu_q", "mu_s", "nu_q", "nu_s")})
    got8, got32 = tables(kparams, kstate)
    grads = {k: rand(s, gen, 1e-3, g_dtype) for k, s in zip(keys, shapes)}
    run8, run32 = step_fns(got8, got32, grads, 2, plain=False)
    plain8, plain32 = step_fns(want8, want32, grads, 2, plain=True)
    run8(), run32(), plain8(), plain32()
    torch.cuda.synchronize()

    err8 = {"mu_q_max": 0, "nu_q_max": 0, "mu_q_share": 0.0, "nu_q_share": 0.0,
            "scales_rel": 0.0, "master_ulps": 0.0, "master_share": 0.0}
    for i, (lead, minor) in enumerate(got8.views):
        for j, name in ((0, "mu_q"), (2, "nu_q")):
            d = (got8.state[i][j].int() - want8.state[i][j].int()).abs()
            err8[name + "_max"] = max(err8[name + "_max"], int(d.max()))
            err8[name + "_share"] = max(err8[name + "_share"], float((d > 0).float().mean()))
            check(not got8.state[i][j][:, minor:].any(),
                  f"adam8_fused {name} padded tail not zero in {got8.keys[i]}")
        for j in (1, 3):
            err8["scales_rel"] = max(err8["scales_rel"],
                                     rel_err(got8.state[i][j], want8.state[i][j]))
        ulps, share = master_flips(got8.params[i], want8.params[i])
        err8["master_ulps"] = max(err8["master_ulps"], ulps)
        err8["master_share"] = max(err8["master_share"], share)
    err8["out"] = max(max_abs(a, b) for a, b in zip(got8.params, want8.params))
    check(err8["mu_q_max"] <= 1 and err8["nu_q_max"] <= 1
          and max(err8["mu_q_share"], err8["nu_q_share"]) < PAYLOAD_FLIPS
          and err8["scales_rel"] <= OPT_TOL and err8["master_ulps"] <= 1.0
          and err8["master_share"] < MASTER_FLIPS,
          f"grouped adam8_fused disagrees with its plain chain: {err8}")
    err32 = {what: all(torch.equal(a, b) for a, b in zip(getattr(got32, what),
                                                          getattr(want32, what)))
             for what in ("params", "mu", "nu")}
    err32["out"] = max(max_abs(a, b) for a, b in zip(got32.params, want32.params))
    check(err32["params"] and err32["mu"] and err32["nu"],
          f"grouped adam_bf16_fused (AdamW8bit's fp32-moment leaves) disagrees: {err32}")
    g_size = torch.empty((), dtype=g_dtype).element_size()
    return {"adam8_fused": group_record(got8, want8, run8, plain8, "adam8_group",
                                        ADAM8_OPS + EPILOGUE_OPS, err8, g_size),
            "adam_bf16_fused_fp32_leaves": group_record(got32, want32, run32, plain32,
                                                        "adam_bf16_group",
                                                        ADAM_OPS + EPILOGUE_OPS, err32, g_size)}


def optim_phase(gen: torch.Generator) -> dict:
    res = {"adam8_fused": [adam8_case(s, gen) for s in INT8_SHAPES],
           "adam_bf16_fused": [adam_case(s, dt, sr, xla, gen) for s, dt, sr, xla in ADAM_CASES]}
    keys, shapes = sd15_leaves()
    res["grouped"] = {"adam_bf16_fused": adamw_group_case(gen, keys, shapes)}
    torch.cuda.empty_cache()
    # the default AdamW (fp32 masters and moments): XLA's rounding
    res["grouped_xla"] = {"adam_bf16_fused": adamw_group_case(gen, keys, shapes, xla=True)}
    torch.cuda.empty_cache()
    res["grouped_int8"] = adamw8bit_group_case(gen, keys, shapes)
    torch.cuda.empty_cache()
    # fp32 gradients, as gradient accumulation hands both kernels their mean
    res["grouped_fp32_grads"] = {
        "adam_bf16_fused": adamw_group_case(gen, keys, shapes, torch.float32)}
    torch.cuda.empty_cache()
    res["grouped_int8_fp32_grads"] = adamw8bit_group_case(gen, keys, shapes, torch.float32)
    torch.cuda.empty_cache()
    return res


def setup_train(seed: int, optimizer: str = "adamw", extra: dict | None = None,
                device: str = "cuda", **spec_kw):
    """The bench.py default workload on the port: SD1.5 at full width, 512^2
    (64^2 latents), batch 8, cached random latents/conds, bf16 masters, bf16
    moments (int8 with ``optimizer="bitsandbytes.optim.AdamW8bit"``), EMA off,
    no remat. ``extra`` is merged over the config, ``spec_kw`` go to
    ``StepSpec.from_config``. Returns a dict with the config, the train state,
    the step function and the pieces it closes over (spec, tx), the batch and
    the UNet config."""
    batch_size, latent = 8, 64
    config = merge(default(), Config({
        "batch_size": batch_size,
        "gradient_checkpointing": False,
        "trainer": {"precision": "bf16"},
        "ema": {"enabled": False},
        "optimizer": {"name": optimizer, "moment_dtype": "bf16", "master_dtype": "bf16",
                      "params": {"lr": 2e-6, "beta1": 0.9, "beta2": 0.999,
                                 "weight_decay": 1e-2, "eps": 1e-8},
                      "lr_scale": {"enabled": False}},
    }), Config(extra or {}))
    unet_config = UNetConfig.sd15()
    params = init_unet_params(unet_config, seed=seed, device=device)
    resolutions = resolve_optim_target(load_optim_target("full_unet"), params.keys(), [])
    labels = group_labels(resolutions)
    overrides = {f"g{i}": g.optimizer for i, g in enumerate(resolutions["unet"].groups)}
    trainable = {f"unet.{k}": v.to(torch.bfloat16) for k, v in params.items()}
    del params
    tx, lr_fn = build_optimizer(config, labels, overrides, steps_per_epoch=1000, num_processes=1)
    spec = StepSpec.from_config(config, unet_config, **spec_kw)
    ema = config.ema
    state = init_train_state(trainable, tx, seed=seed, ema_enabled=bool(ema.enabled),
                             ema_decay=float(ema.decay),
                             ema_dtype=torch.bfloat16 if ema.dtype == "bf16" else torch.float32)
    step_fn = make_train_step(spec, tx, lr_fn, ema_enabled=bool(ema.enabled))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    batch = {"latents": torch.randn(batch_size, 4, latent, latent, generator=gen, device=device),
             "conds": torch.randn(batch_size, 77, unet_config.cross_attention_dim,
                                  generator=gen, device=device)}
    return {"config": config, "state": state, "step_fn": step_fn, "spec": spec, "tx": tx,
            "lr_fn": lr_fn, "batch": batch, "unet_config": unet_config}


def optimizer_launches(opt_state: dict) -> dict[str, int]:
    """Launches per step of each optimizer kernel: adam8_fused once per param
    group that holds int8 leaves (AdamW8bit); adam_bf16_fused once per step
    over every group's other Adam leaves (AdamW's, AdamW8bit's fp32-moment
    ones), one launch per kind of group and moment dtypes."""
    out = {"adam8_fused": 0}
    signatures = set()
    for s in opt_state.values():
        if hasattr(s, "mu_s"):
            out["adam8_fused"] += bool(s.mu_s)
            fp32 = [v for k, v in s.mu_q.items() if k not in s.mu_s]
            if fp32:
                signatures.add(("adamw8bit", fp32[0].dtype))
        elif s.mu:
            mu, nu = next(iter(s.mu.values())), next(iter(s.nu.values()))
            signatures.add(("adamw", mu.dtype, nu.dtype))
    out["adam_bf16_fused"] = len(signatures)
    return out


def train_phase(seed: int, steps: int, optimizer: str, per_step: dict[str, int],
                warmup: int = 3) -> dict:
    """Warm-up, then ``steps`` timed steps; ``per_step`` gives the launches
    per step each splash kernel must make in the timed steps, and each
    optimizer kernel must launch as ``optimizer_launches`` says."""
    setup = setup_train(seed, optimizer)
    state, step_fn, batch, unet_config = (setup[k] for k in ("state", "step_fn", "batch",
                                                               "unet_config"))
    groups = len(setup["tx"].transforms)
    per_step = {**per_step, **optimizer_launches(state.opt_state), "ema_fused": 0}
    del setup
    res = run_steps(state, step_fn, {}, lambda: batch, steps, warmup, per_step)
    # the same steps with the loss fetched after each, as the trainer's
    # logging does: what the host sync costs
    state = res["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, {}, batch)
        float(metrics["train_loss"])
    res["synced_steps_per_s"] = steps / (time.perf_counter() - t0)
    res["state"] = state
    return {**res, "param_groups": groups, "batch": batch, "unet_config": unet_config}


def run_steps(state, step_fn, frozen: dict, next_batch, steps: int, warmup: int,
              per_step: dict[str, int], probe: list[str] | None = None) -> dict:
    """``warmup`` steps, then ``steps`` timed steps on ``next_batch()``'s
    batches, the launch counts reset just before them: each kernel in
    ``per_step`` must launch that many times per timed step, the losses be
    finite and the params move (the ``probe`` keys; default three UNet
    attention projections and conv_in). Host clock around the timed steps,
    ending in a synchronize; peak memory over them."""
    if probe is None:
        probe = ([k for k in sorted(state.trainable) if "attn1.to_q" in k][:3]
                 + ["unet.conv_in.weight"])
    before = {k: state.trainable[k].clone() for k in probe}

    t0 = time.perf_counter()
    for _ in range(warmup):
        state, metrics = step_fn(state, frozen, next_batch())
        check(math.isfinite(metrics["train_loss"].item()), "non-finite loss in warm-up")
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, metrics = step_fn(state, frozen, next_batch())
        losses.append(metrics["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()

    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"{name} launched {launches[name]} times in {steps} steps, expected {n} per step")
    moved = [k for k in probe if not torch.equal(before[k], state.trainable[k])]
    check(len(moved) == len(probe), f"parameters did not change: {set(probe) - set(moved)}")
    return {"steps": steps, "warmup_s": warm_s, "timed_s": dt, "steps_per_s": steps / dt,
            "optimizer_launches_per_step": per_step,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": losses, "launches": launches, "state": state}


# the families phase: (config name, params over setup_train's), with AdamW
# first as the reference the others are printed beside
FAMILIES = (("adamw", {}), ("adam", {}), ("lion", {}), ("adafactor", {}),
            ("prodigyopt.Prodigy", {"lr": 1.0}), ("dadaptation.DAdaptAdam", {"lr": 1.0}),
            ("sgd", {"lr": 1e-3}))   # SGD's step is lr * g: 2e-6 would move no bf16 master
# the leaves whose first update on the card is held against the CPU's
FAMILY_PROBE = ("unet.conv_in.weight",
                "unet.down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k.weight",
                "unet.up_blocks.3.resnets.2.norm2.bias")
# card vs CPU, first update of FAMILY_PROBE: elementwise chains bit for bit;
# the Adam kernel against its plain version 1e-6 relative (phase 3's bound);
# chains with reductions (another summation order) 1e-5 of the largest entry
FAMILY_FIRST_TOL = {"adamw": 1e-6, "adam": 1e-6, "lion": 0.0, "sgd": 0.0, "adafactor": 1e-5,
                    "prodigyopt.Prodigy": 1e-5, "dadaptation.DAdaptAdam": 1e-5}
FAMILY_STEPS = 2         # warm-up and timed steps per family (2 + 2)
# untimed steps Prodigy / D-Adapt may take until estim_lr > d0: 27 steps in all,
# as before the timed steps were cut from 5 to 2
FAMILY_MORE_STEPS = 23


def sd15_pack_spec(config, labels: dict):
    """The slab spec the JAX trainer's default packing gives the full_unet
    trainables (fp32 at load), which Adafactor treats as blocks."""
    from scal_sdt_tpu_torch.training.trainer import jax_pack_spec

    shapes = {f"unet.{k}": torch.empty(s, device="meta")
              for k, s in unet_param_shapes(UNetConfig.sd15()).items()}
    return jax_pack_spec(config, {k: v for k, v in shapes.items() if k in labels}, labels)


def first_update_check(name: str, config, labels: dict, overrides: dict, masters: dict,
                       grads: dict) -> dict:
    """The family's first update of FAMILY_PROBE's leaves on the card and on
    the CPU, from the same fresh state, masters and gradients."""
    sub = {k: labels[k] for k in FAMILY_PROBE}
    out = {}
    for dev in ("cuda", "cpu"):
        tx, _ = build_optimizer(config, sub, {g: overrides[g] for g in set(sub.values())
                                              if g in overrides}, 1000, 1)
        p = {k: masters[k].to(dev, copy=True) for k in FAMILY_PROBE}
        g = {k: grads[k].to(dev, copy=True) for k in FAMILY_PROBE}
        u, _ = tx.update(g, tx.init(p), p)
        out[dev] = {k: v.float().cpu() for k, v in u.items()}
    err = {k: max_abs(out["cuda"][k], out["cpu"][k])
           / max(out["cpu"][k].abs().max().item(), 1e-30) for k in FAMILY_PROBE}
    tol = FAMILY_FIRST_TOL[name]
    check(all(e <= tol for e in err.values()),
          f"{name}: first update on the card vs the CPU, relative to the largest entry {err} > "
          f"{tol}")
    return {"rel_err": err, "tol": tol}


def optimizer_cost(tx, state, frozen: dict, batch: dict, step_fn_spec) -> dict:
    """The optimizer's share of a step: ``tx.update_and_apply`` on one set of
    gradients, its host ms (the call's return, after a synchronize before
    it; median of 3), its device ms and CUDA launches per call (a
    torch.profiler trace of one call: the sum of its kernels' times; None
    when no trace held any)."""
    from torch.profiler import ProfilerActivity, profile

    _, grads = loss_and_grads(step_fn_spec, state.trainable, frozen, batch, state.generator)
    opt, host = state.opt_state, []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = tx.update_and_apply(grads, opt, state.trainable, state.step + i)
        host.append((time.perf_counter() - t0) * 1e3)
    # a trace may miss the card's work of a call now and then, the launches
    # of the ops/ kernels most often: the fullest of up to 3 traces counts
    traces = []
    for i in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opt = tx.update_and_apply(grads, opt, state.trainable, state.step + 3 + i)
            torch.cuda.synchronize()
        traces.append([e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA])
        if len(traces) > 1 and traces[-1] and len(traces[-1]) == len(traces[-2]):
            break
    del grads
    kernels = max(traces, key=len)
    return {"host_ms": sorted(host)[1],
            "device_ms": sum(kernels) / 1e3 if kernels else None,
            "launches": len(kernels), "traced_launches": [len(t) for t in traces],
            "opt_state": opt}


def families_phase(seed: int, steps: int, per_step: dict[str, int], warmup: int = 2) -> dict:
    """The train phase's step (SD1.5 full fine-tune, bf16 masters and
    moments) under each optimizer family: ``warmup`` steps, then ``steps``
    timed steps; each splash kernel 10 launches per step, adam_bf16_fused 1
    under adam (and the AdamW reference) and 0 under the others; loss finite,
    masters moved. Prodigy's and D-Adapt's estim_lr must rise above d0 (up
    to FAMILY_MORE_STEPS more untimed steps). The first update of three
    leaves is held against the CPU's; the optimizer's host and device ms
    and launches per step are measured apart (``optimizer_cost``)."""
    out: dict = {"families": {}}
    launches = {k: 0 for k in read_launches()}
    first_masters = first_grads = None
    for name, params in FAMILIES:
        extra = {"optimizer": {"params": params}} if params else None
        setup = setup_train(seed, name, extra)
        tx, state, step_fn, batch = (setup[k] for k in ("tx", "state", "step_fn", "batch"))
        config, spec = setup["config"], setup["spec"]
        labels = dict(tx.labels)
        overrides = {f"g{i}": g.optimizer for i, g in enumerate(resolve_optim_target(
            load_optim_target("full_unet"), unet_param_shapes(UNetConfig.sd15()), [])
            ["unet"].groups)}
        if name == "adafactor":   # the JAX trainer's default slabs are its blocks
            pack = sd15_pack_spec(config, labels)
            tx, _ = build_optimizer(config, labels, overrides, 1000, 1, pack_spec=pack)
            state = state._replace(opt_state=tx.init(state.trainable))
            step_fn = make_train_step(spec, tx, setup["lr_fn"])
        del setup
        if first_masters is None:   # the same seed gives every family the same start
            _, g = loss_and_grads(spec, state.trainable, {}, batch,
                                  torch.Generator(device="cuda").manual_seed(seed + 7))
            first_masters = {k: state.trainable[k].clone() for k in FAMILY_PROBE}
            first_grads = {k: g[k].clone() for k in FAMILY_PROBE}
            del g
        first = first_update_check(name, config, labels, overrides, first_masters, first_grads)
        groups = len(tx.transforms)
        want = {**per_step,
                "adam_bf16_fused": ADAM_PER_STEP if name in ("adamw", "adam") else 0,
                "adam8_fused": 0, "ema_fused": 0}
        res = run_steps(state, step_fn, {}, lambda: batch, steps, warmup, want)
        for k, v in res["launches"].items():
            launches[k] += v
        state = res.pop("state")
        extra_steps = 0
        if name in ("prodigyopt.Prodigy", "dadaptation.DAdaptAdam"):
            d0 = float(config.optimizer.params.get("d0", 1e-6))

            def estimates():
                return [float(s.estim_lr) for s in state.opt_state.values()]

            while min(estimates()) <= d0 and extra_steps < FAMILY_MORE_STEPS:
                state, _ = step_fn(state, {}, batch)
                extra_steps += 1
            check(min(estimates()) > d0, f"{name}: estim_lr {estimates()} still at d0 {d0} after "
                                         f"{warmup + steps + extra_steps} steps")
            res["estim_lr"] = estimates()
        cost = optimizer_cost(tx, state, {}, batch, spec)
        state = state._replace(opt_state=cost.pop("opt_state"))
        out["families"][name] = {**{k: v for k, v in res.items() if k != "launches"},
                                 "launches": res["launches"], "param_groups": groups,
                                 "first_update": first, "optimizer": cost,
                                 "extra_steps_to_move_estim_lr": extra_steps}
        del state, tx, step_fn, batch, res
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def lora_prodigy_phase(seed: int, workdir: Path, model: Path, images: Path) -> dict:
    """configs/lora.yaml through the train CLI with optimizer
    prodigyopt.Prodigy at lr 1.0 (the community's LoRA recipe), sampling off:
    LORA_PRODIGY_STEPS steps with a checkpoint at LORA_PRODIGY_SAVE; a run
    resumed from it must end on run 1's checkpoint and sidecar bit for bit
    (Prodigy's params0, moments and 0-dim estim_lr in the sidecar). Splash
    launches as the buckets give them, no adam_bf16_fused launch."""
    runs, timings = workdir / "lora_prodigy_runs", workdir / "lora_prodigy_timings.jsonl"
    base = load_with_defaults(CONFIGS_DIR / "lora.yaml")
    config = merge(base, Config({
        "model": str(model), "output_dir": str(runs), "project": "lora_prodigy", "seed": seed,
        "num_workers": NUM_WORKERS,
        "data": {"concepts": [{"instance_set": {"path": str(images), "prompt": "{TXT_PROMPT}"}}]},
        "sampling": {"interval_steps": 10 ** 6},
        # lr 1.0 as the recipe gives it: lora.yaml's sqrt lr scaling would double it
        "optimizer": {"name": "prodigyopt.Prodigy", "params": {"lr": 1.0},
                      "lr_scale": {"enabled": False}},
        "trainer": {"max_steps": LORA_PRODIGY_STEPS, "log_every_n_steps": 1},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None,
                       "every_n_train_steps": LORA_PRODIGY_SAVE, "monitor": None},
        "loggers": {"tensorboard": None}}))
    cfg_path = workdir / "lora_prodigy.yaml"
    cfg_path.write_text(json.dumps(config))
    unet_config = UNetConfig.sd15()
    os.environ["SSDT_STEP_TIMINGS"] = str(timings)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run1 = TrainerProbe()
        with run1:
            train_cli.main(["--config", str(cfg_path), "--run-id", "run1", "--device", DEVICE],
                           standalone_mode=False)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        shapes1 = step_shapes(timings)
        l1 = run1.losses()
        check(sorted(l1) == list(range(1, LORA_PRODIGY_STEPS + 1))
              and all(math.isfinite(x) for x in l1.values()), f"lora prodigy losses {l1}")
        expect_train_splash(shapes1, launches, "lora prodigy run 1", unet_config)
        check(launches["adam_bf16_fused"] == 0 and launches["ema_fused"] == 0
              and launches["adam8_fused"] == 0, f"lora prodigy launches {launches}")
        dir1 = runs / "lora_prodigy" / "run1"
        mid, last = (f"epoch=0-step={n}" for n in (LORA_PRODIGY_SAVE, LORA_PRODIGY_STEPS))
        side = load_state_dict(dir1 / f"{mid}.safetensors.torchstate", "safetensors")
        estim = {k: float(v) for k, v in side.items() if k.endswith(".estim_lr")}
        check(bool(estim) and any(".params0." in k for k in side),
              f"the sidecar lacks Prodigy's state: {sorted(side)[:5]}")
        want = file_digests(checkpoint_files(dir1, last))
        reset_launches()
        run2 = TrainerProbe()
        with run2:
            train_cli.main(["--resume", str(dir1 / f"{mid}.safetensors"), "--run-id", "run2",
                            "--device", DEVICE], standalone_mode=False)
        launches2 = read_launches()
        gc.collect()
        torch.cuda.empty_cache()
        expect_train_splash(step_shapes(timings), launches2, "lora prodigy run 2", unet_config)
        got = file_digests(checkpoint_files(runs / "lora_prodigy" / "run2", last))
        check(got == want, f"the resumed Prodigy LoRA run's checkpoint differs: {got} {want}")
        l2 = run2.losses()
        check(sorted(l2) == list(range(LORA_PRODIGY_SAVE + 1, LORA_PRODIGY_STEPS + 1))
              and all(l2[s] == l1[s] for s in l2), f"resumed losses {l2} != run 1's {l1}")
    finally:
        os.environ.pop("SSDT_STEP_TIMINGS", None)
    logged = [t for s, _, t in run1.steps]
    timed = [b - a for a, b in zip(logged[1:], logged[2:])]   # the first step left out
    return {"steps": LORA_PRODIGY_STEPS, "losses": l1, "resumed_losses": l2,
            "steps_per_s": len(timed) / sum(timed) if timed else float("nan"),
            "estim_lr_at_save": estim, "peak_mem_gib": peak, "launches": launches,
            "launches_per_step": {k: v / LORA_PRODIGY_STEPS for k, v in launches.items()},
            "bucket_shapes": shapes1}


@torch.no_grad()
def check_phase(train: dict) -> dict:
    """One sample through the UNet with the kernels, then with the plain
    attention path (the kernel gate closed), on the trained bf16 params."""
    state, batch, cfg = train["state"], train["batch"], train["unet_config"]
    params = {k[len("unet."):]: v for k, v in state.trainable.items()}
    x, ctx = batch["latents"][:1].bfloat16(), batch["conds"][:1].bfloat16()
    t = torch.tensor([500], device="cuda")
    with_kernels = unet_apply(params, x, t, ctx, cfg)
    gate = attention.KERNEL_MIN_LEN
    attention.KERNEL_MIN_LEN = 1 << 30
    try:
        plain = unet_apply(params, x, t, ctx, cfg)
    finally:
        attention.KERNEL_MIN_LEN = gate
    check(with_kernels.shape == (1, 4, 64, 64), f"output shape {tuple(with_kernels.shape)}")
    check(bool(torch.isfinite(with_kernels).all()), "non-finite UNet output")
    err = rel_err(with_kernels, plain)
    check(err <= CHECK_TOL, f"UNet output, kernel path vs plain path: {err}")
    return {"unet_rel_err": err}


def write_images(root: Path, n: int, seed: int) -> Path:
    """``n`` PNG files of random pixels from ``seed``, non-square
    (IMAGE_SIZES in turn) so the pipeline's resize and crop run, each with a
    .txt caption."""
    from PIL import Image

    d = root / "images"
    d.mkdir(parents=True)
    r = np.random.RandomState(seed)
    for i in range(n):
        w, h = IMAGE_SIZES[i % len(IMAGE_SIZES)]
        Image.fromarray(r.randint(0, 256, (h, w, 3), np.uint8)).save(d / f"img_{i:03d}.png")
        (d / f"img_{i:03d}.txt").write_text(f"a photo of the cat number {i}, tag {i % 4}")
    return d


def write_vocab(d: Path) -> Path:
    """A synthetic CLIP vocab: every byte symbol, its end-of-word form, a few
    merges, BOS and EOS (537 ids, all inside CLIP's 49408)."""
    d.mkdir(parents=True)
    symbols = list(bytes_to_unicode().values())
    vocab = {}
    for sym in symbols + [sym + "</w>" for sym in symbols] + [a + b for a, b in VOCAB_MERGES]:
        vocab[sym] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in VOCAB_MERGES), encoding="utf-8")
    return d


def epochs(pipeline: DataPipeline):
    """The pipeline's batches, epoch after epoch, moved to the card."""
    check(len(pipeline) > 0, "the pipeline makes no whole batch")
    while True:
        for batch in pipeline:
            yield to_device(batch, DEVICE)


def latent_shape(spec, batch_size: int) -> tuple[int, int, int, int]:
    """(B, C, h, w) of the latents of RESOLUTION^2 images."""
    vae = spec.vae_config
    side = RESOLUTION // 2 ** (len(vae.block_out_channels) - 1)
    return batch_size, vae.latent_channels, side, side


def component(params: dict, prefix: str) -> dict:
    """The params under ``prefix.``, the prefix stripped."""
    return {k[len(prefix) + 1:]: v for k, v in params.items() if k.startswith(prefix + ".")}


@torch.no_grad()
def vae_latents(frozen: dict, spec, images: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Latents of ``images``: the VAE moments and a sample of their Gaussian
    with ``noise``, in the compute dtype."""
    vae, dt = spec.vae_config, spec.compute_dtype
    params = {k: v.to(dt) for k, v in component(frozen, "vae").items()}
    moments = encoder_apply(params, images.to(dt), vae)
    return sample_latents(moments, noise, vae.scaling_factor, vae.shift_factor)


@torch.no_grad()
def clip_conds(frozen: dict, spec, input_ids: torch.Tensor) -> torch.Tensor:
    params = {k: v.to(spec.compute_dtype)
              for k, v in component(frozen, "condition_model.encoder").items()}
    return clip_text_apply(params, input_ids, spec.clip_config, spec.clip_stop_at_layer)


def encode_apart(frozen: dict, spec, batch: dict, noise: torch.Tensor,
                 u: torch.Tensor) -> dict:
    """The cached batch that the uncached step computes inside itself, here
    from the public functions: latents from the VAE and ``noise``, CLIP
    conds dropped to zeros when ``u < p``."""
    conds = clip_conds(frozen, spec, batch["input_ids"])
    return {"latents": vae_latents(frozen, spec, batch["images"], noise),
            "conds": torch.where(u < spec.uncond_p, torch.zeros_like(conds), conds)}


@torch.no_grad()
def consistency_check(state, frozen: dict, spec, batch: dict, seed: int) -> dict:
    """On one batch with fixed draws (once with the CFG drop, once without):
    the uncached ``compute_loss`` against ``compute_loss`` on the latents and
    conds computed apart (``encode_apart``) with the same draws. The same
    kernels run on the same inputs in the same order, so the losses must be
    equal bit for bit."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    res = {}
    for u in (0.05, 0.5):
        u = torch.tensor(u, device=DEVICE)
        noise = torch.randn(latent_shape(spec, batch["images"].shape[0]), generator=gen,
                            dtype=spec.compute_dtype, device=DEVICE)
        apart = encode_apart(frozen, spec, batch, noise, u)
        draws = draw(gen, spec, apart["latents"], noise, u)
        got = compute_loss(state.trainable, frozen, batch, None, spec, draws)[0]
        want = compute_loss(state.trainable, frozen, apart, None, spec, draws)[0]
        res[f"u={float(u)}"] = {"uncached": float(got), "apart": float(want),
                                "equal": torch.equal(got, want)}
        check(torch.equal(got, want) and math.isfinite(float(got)),
              f"uncached loss {float(got)!r} != loss on latents/conds computed apart "
              f"{float(want)!r} (u = {float(u)})")
    return res


def setup_uncached(seed: int, workdir: Path) -> dict:
    """The uncached SD1.5 fine-tune at full width: ``setup_train``'s UNet and
    optimizer, VAE and CLIP ViT-L with random weights from ``seed`` (frozen,
    in bf16), and the port's DataPipeline (batches of 8 at 512^2) over PNG
    files written under ``workdir``, tokenized with CLIP-BPE on a synthetic
    vocab, CFG dropout ('zeros', p = 0.1). Returns setup_train's dict with
    ``frozen``, ``tokenizer`` and ``pipeline`` added."""
    data = write_images(workdir, UNCACHED_IMAGES, seed)
    tokenizer = CLIPBPETokenizer.from_dir(write_vocab(workdir / "tokenizer"))
    check(int(tokenizer([""]).max()) < CLIPTextConfig.vit_l().vocab_size, "ids out of range")
    vae_config, clip_config = VAEConfig.sd15(), CLIPTextConfig.vit_l()
    setup = setup_train(seed, "adamw", {
        "seed": seed, "num_workers": NUM_WORKERS,
        "uncond": {"enabled": True, "p": 0.1, "cond": "zeros"},
        "data": {"resolution": RESOLUTION, "concepts": [
            {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
    }, device=DEVICE, vae_config=vae_config, clip_config=clip_config)
    config = setup["config"]
    setup["frozen"] = {
        **{f"vae.{k}": v.bfloat16()
           for k, v in init_vae_params(vae_config, seed + 2, DEVICE).items()},
        **{f"condition_model.encoder.{k}": v.bfloat16()
           for k, v in init_clip_params(clip_config, seed + 3, DEVICE).items()}}
    dataset = get_dataset(config, use_cache=False)
    setup["pipeline"] = DataPipeline(dataset, get_sampler(dataset, config, 1, 0),
                                     config.batch_size, tokenizer, num_workers=NUM_WORKERS)
    setup["tokenizer"] = tokenizer
    return setup


def uncached_phase(seed: int, steps: int, workdir: Path, per_step: dict[str, int],
                   warmup: int = 3) -> dict:
    """``setup_uncached``'s step, warmed up, then ``steps`` timed steps: each
    splash kernel and the optimizer kernels launch as in the cached step
    (the VAE's and CLIP's attention take the math path); then the device
    time of the VAE encode and of CLIP per step, and the consistency
    check. Fails unless the images decode through the native decoder
    (``native/image.py``), as the JAX package decodes them."""
    check(native_image.decoder_name() == "native",
          f"the uncached phase would decode with PIL: the native decoder did not build "
          f"({native_image.build_error})")
    setup = setup_uncached(seed, workdir)
    config, state, step_fn, spec, frozen = (setup[k] for k in ("config", "state", "step_fn",
                                                               "spec", "frozen"))
    per_step = {**per_step, **optimizer_launches(state.opt_state)}
    batches = epochs(setup["pipeline"])
    res = run_steps(state, step_fn, frozen, lambda: next(batches), steps, warmup, per_step)
    state = res["state"]

    batch = next(batches)
    batches.close()
    b = config.batch_size
    check(tuple(batch["images"].shape) == (b, 3, RESOLUTION, RESOLUTION),
          f"images {tuple(batch['images'].shape)}")
    res["consistency"] = consistency_check(state, frozen, spec, batch, seed)
    noise = torch.randn(latent_shape(spec, b), device=DEVICE, dtype=spec.compute_dtype)
    # a 1 s spin, so the host has queued every call before it ends, even
    # with the pipeline's threads still decoding beside it
    res["vae_ms"] = device_ms(lambda: vae_latents(frozen, spec, batch["images"], noise),
                              iters=5, warmup=1, hold_cycles=2_000_000_000)
    res["clip_ms"] = device_ms(lambda: clip_conds(frozen, spec, batch["input_ids"]),
                               iters=5, warmup=1, hold_cycles=2_000_000_000)
    res["vae_images_per_s"] = b * 1e3 / res["vae_ms"]
    res.update(images=UNCACHED_IMAGES, image_sizes=IMAGE_SIZES, config=config, frozen=frozen,
               tokenizer=setup["tokenizer"], spec=spec, step_fn=step_fn, state=state,
               per_step=per_step)
    return res


DECODER_ROUNDS, DECODER_EPOCHS = 2, 2   # the decoders alternate; epochs timed per turn


def decoder_leg(uncached: dict, steps: int = 3) -> dict:
    """The uncached pipeline with each decoder on the same PNGs: the native
    decoder (``native/image.py``, the build that succeeded here) and PIL
    (the decoder switched off): DECODER_ROUNDS turns each, alternating,
    of DECODER_EPOCHS epochs through the pipeline alone (images/s, host;
    one epoch of 24 images is too short to time alone), then ``steps``
    uncached train steps on each one's batches (steps/s)."""
    out: dict = {"active": native_image.decoder_name(), "build": native_image.active_build,
                 "build_error": native_image.build_error.splitlines()[:2],
                 "builds": {b.name: [p.name for p in b.libraries]
                            for b in native_image.builds()}}
    config = uncached["config"]
    available = native_image.available
    names = ("native", "pil") if available() else ("pil",)
    out["native"] = None

    def pipeline(name: str) -> DataPipeline:
        native_image.available = available if name == "native" else (lambda: False)
        dataset = get_dataset(config, use_cache=False)
        return DataPipeline(dataset, get_sampler(dataset, config, 1, 0), config.batch_size,
                            uncached["tokenizer"], num_workers=NUM_WORKERS)

    rates: dict = {name: [] for name in names}
    try:
        for _ in range(DECODER_ROUNDS):
            for name in names:
                pipe = pipeline(name)
                t0 = time.perf_counter()
                n = sum(len(b["ids"]) for _ in range(DECODER_EPOCHS) for b in pipe)
                rates[name].append(n / (time.perf_counter() - t0))
        for name in names:
            batches = epochs(pipeline(name))
            res = run_steps(uncached["state"], uncached["step_fn"], uncached["frozen"],
                            lambda: next(batches), steps, 1, uncached["per_step"])
            batches.close()
            uncached["state"] = res["state"]
            out[name] = {"images": n, "images_per_s": rates[name],
                         "steps_per_s": res["steps_per_s"], "losses": res["losses"]}
    finally:
        native_image.available = available
    return out


def cache_phase(uncached: dict, workdir: Path, per_step: dict[str, int],
                steps: int = 2) -> dict:
    """The port's cache builder on the uncached phase's images, VAE and CLIP
    (held in memory, bf16): build_local_shard, assemble_cache,
    save_state_dict; then the file read back through LatentCache,
    DataPipeline and to_device, and ``steps`` cached train steps from it.
    Fails unless the images decode through the native decoder."""
    check(native_image.decoder_name() == "native",
          f"the cache phase would decode with PIL ({native_image.build_error})")
    config, frozen, spec = uncached["config"], uncached["frozen"], uncached["spec"]
    models = LoadedModels(unet={}, unet_config=spec.unet_config, vae=component(frozen, "vae"),
                          vae_config=spec.vae_config,
                          clip=component(frozen, "condition_model.encoder"),
                          clip_config=spec.clip_config, schedule=spec.schedule)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shard = build_local_shard(config, models, uncached["tokenizer"], no_conds=False,
                              aug_group_size=1, batch_size=config.batch_size, device=DEVICE)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cache, metadata = assemble_cache(shard)
    path = workdir / "cache.safetensors"
    save_state_dict(cache, path, metadata=save_json_metadata(metadata))
    n = uncached["images"]
    check(metadata["total_entries"] == n and metadata["aug_group_size"] == 1,
          f"cache metadata {metadata['total_entries']} entries")
    b, c, h, w = latent_shape(spec, config.batch_size)
    cond = (spec.clip_config.max_position_embeddings, spec.clip_config.hidden_size)
    check(all(size == [h, w, c] for size in metadata["sizes"].values()), "latent sizes")
    check(tuple(cache["0.cond"].shape) == cond and cache["0.latent.0"].dtype == torch.bfloat16,
          f"cond {tuple(cache['0.cond'].shape)}, latent {cache['0.latent.0'].dtype}")
    check(all(bool(torch.isfinite(t).all()) for t in cache.values()), "non-finite cache entry")

    cached = merge(config, Config({"data": {"cache": str(path)}}))
    dataset = get_dataset(cached)
    check(isinstance(dataset.cache, LatentCache) and len(dataset) == n, "cache not read back")
    pipeline = DataPipeline(dataset, get_sampler(dataset, cached, 1, 0), config.batch_size,
                            num_workers=NUM_WORKERS)
    batches = epochs(pipeline)
    first = next(batches)
    check(tuple(first["latents"].shape) == (b, c, h, w)
          and tuple(first["conds"].shape) == (b, *cond), "cached batch shapes")
    res = run_steps(uncached["state"], uncached["step_fn"], frozen, lambda: next(batches),
                    steps, 0, per_step)
    batches.close()
    return {"decoder": native_image.decoder_name(), "decoder_build": native_image.active_build,
            "images": n, "encoded": len(shard["ids"]), "encode_s": encode_s,
            "images_per_s": len(shard["ids"]) / encode_s,
            "file_mib": path.stat().st_size / 2 ** 20,
            **{k: res[k] for k in ("steps", "timed_s", "steps_per_s", "peak_mem_gib",
                                   "losses", "launches")}}


TRAINER_STEPS = 6        # run 1 of the trainer phase; 3 steps per epoch of the cache
TRAINER_SAVE_EVERY = 4   # its mid-epoch checkpoint (epoch 1, batch 1), which run 2 resumes
ACCUM_K, ACCUM_MICRO_STEPS = 2, 4
SD15_SCHEDULER = {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
                  "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
                  "steps_offset": 1, "clip_sample": False, "set_alpha_to_one": False}


def write_model_dir(root: Path, seed: int, frozen: dict) -> Path:
    """A diffusers directory of SD1.5 at full width in bf16: a UNet with
    random weights from ``seed``, the VAE and CLIP ViT-L of ``frozen``, the
    SD1.5 scheduler config and the synthetic CLIP vocab."""
    d = root / "model"
    unet = {k: v.bfloat16() for k, v in
            init_unet_params(UNetConfig.sd15(), seed=seed + 4, device=DEVICE).items()}
    parts = {"unet": (unet, UNetConfig.sd15()),
             "vae": (component(frozen, "vae"), VAEConfig.sd15()),
             "text_encoder": (component(frozen, "condition_model.encoder"),
                              CLIPTextConfig.vit_l())}
    for name, (params, cfg) in parts.items():
        (d / name).mkdir(parents=True)
        save_state_dict(params, d / name / "diffusion_pytorch_model.safetensors")
        (d / name / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    del unet
    (d / "scheduler").mkdir()
    (d / "scheduler" / "scheduler_config.json").write_text(json.dumps(SD15_SCHEDULER))
    write_vocab(d / "tokenizer")
    return d


class TrainerProbe:
    """What Trainer runs do, read at their public methods while the probe is
    open: each logged step's metrics and host time since the probe opened,
    and the seconds of each checkpoint save and resume."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps: list[tuple[int, dict, float]] = []
        self.saves: list[tuple[str, float]] = []
        self.resumes: list[float] = []

    def __enter__(self):
        self._real = (Trainer._log, CheckpointManager.save, Trainer.resume)
        log, save, resume = self._real
        probe = self

        def _log(tr, metrics, step):
            probe.steps.append((step, dict(metrics), time.perf_counter() - probe.t0))
            return log(tr, metrics, step)

        def _save(mgr, *args, **kwargs):
            t0 = time.perf_counter()
            path = save(mgr, *args, **kwargs)
            probe.saves.append((path.name, time.perf_counter() - t0))
            return path

        def _resume(tr, path):
            t0 = time.perf_counter()
            resume(tr, path)
            probe.resumes.append(time.perf_counter() - t0)

        Trainer._log, CheckpointManager.save, Trainer.resume = _log, _save, _resume
        return self

    def __exit__(self, *exc):
        Trainer._log, CheckpointManager.save, Trainer.resume = self._real

    def losses(self) -> dict[int, float]:
        return {step: m["train_loss"] for step, m, _ in self.steps}


def file_digests(paths) -> dict[str, str]:
    out = {}
    for p in paths:
        h = hashlib.sha256()
        with open(p, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 24), b""):
                h.update(chunk)
        out[p.name] = h.hexdigest()
    return out


def checkpoint_files(run: Path, stem: str) -> list[Path]:
    return [run / f"{stem}.safetensors", run / f"{stem}.safetensors.torchstate"]


def leaf_digests(trainer) -> torch.Tensor:
    """One int64 per master: the sum of its bf16 bit patterns, which moves
    when any of its elements does (almost surely)."""
    return torch.stack([p.view(torch.int16).sum(dtype=torch.int64)
                        for p in trainer.state.trainable.values()])


def trainer_config(model: str, runs: Path, cache_path: Path, seed: int) -> dict:
    """The trainer cell's config: SD1.5 from ``cache_path`` at 512^2, batch 8,
    AdamW with bf16 masters and moments, EMA off, a checkpoint every
    TRAINER_SAVE_EVERY steps."""
    return {"model": model, "output_dir": str(runs), "project": "smoke",
            "batch_size": 8, "seed": seed, "num_workers": NUM_WORKERS,
            "data": {"resolution": RESOLUTION, "cache": str(cache_path)},
            "trainer": {"precision": "bf16", "max_epochs": 2, "max_steps": TRAINER_STEPS,
                        "log_every_n_steps": 1},
            "ema": {"enabled": False},
            "optimizer": {"name": "adamw", "master_dtype": "bf16", "moment_dtype": "bf16",
                          "params": {"lr": 2e-6, "weight_decay": 1e-2},
                          "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None,
                           "every_n_train_steps": TRAINER_SAVE_EVERY}}


def trainer_phase(seed: int, workdir: Path, cache_path: Path, frozen: dict,
                  per_step: dict[str, int], train_rate: float) -> dict:
    """The trainer, the train CLI and checkpoints at full width, from the
    cache phase's file: run 1 (``--config``) trains TRAINER_STEPS steps with
    a checkpoint at step TRAINER_SAVE_EVERY (mid-epoch) and at the end; run 2
    (``--resume`` from that checkpoint) trains to the same end, and its final
    checkpoint and sidecar must equal run 1's bit for bit, its losses run
    1's. Then a Trainer with accumulate_grad_batches ACCUM_K over
    ACCUM_MICRO_STEPS micro-steps moves the masters on emit steps only."""
    t0 = time.perf_counter()
    model = write_model_dir(workdir, seed, frozen)
    write_s = time.perf_counter() - t0
    runs = workdir / "runs"
    cfg_path = workdir / "trainer.yaml"
    cfg_path.write_text(json.dumps(trainer_config(str(model), runs, cache_path, seed)))
    # AdamW over bf16 moments: one adam_bf16_fused launch over every param group
    per_step = {**per_step, "adam_bf16_fused": ADAM_PER_STEP, "adam8_fused": 0}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as run1:
        train_cli.main(["--config", str(cfg_path), "--run-id", "run1", "--device", DEVICE],
                       standalone_mode=False)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    check([s for s, _, _ in run1.steps] == list(range(1, TRAINER_STEPS + 1)),
          f"run 1 logged steps {[s for s, _, _ in run1.steps]}")
    check(all(math.isfinite(x) for x in run1.losses().values()), f"losses {run1.losses()}")
    for name, n in per_step.items():
        check(launches[name] == n * TRAINER_STEPS,
              f"{name} launched {launches[name]} times in {TRAINER_STEPS} trainer steps, "
              f"expected {n} per step")
    dir1 = runs / "smoke" / "run1"
    mid, last = (f"epoch=1-step={n}" for n in (TRAINER_SAVE_EVERY, TRAINER_STEPS))
    check(sorted(p.name for p in dir1.glob("*.safetensors")) == [mid + ".safetensors",
                                                                  last + ".safetensors"],
          f"run 1 wrote {sorted(p.name for p in dir1.iterdir())}")
    ckpt_bytes = sum(p.stat().st_size for p in checkpoint_files(dir1, mid))
    want = file_digests(checkpoint_files(dir1, last))
    for p in checkpoint_files(dir1, last):   # at most two checkpoints on disk
        p.unlink()

    with TrainerProbe() as run2:
        train_cli.main(["--resume", str(dir1 / f"{mid}.safetensors"), "--run-id", "run2",
                        "--device", DEVICE], standalone_mode=False)
    gc.collect()
    torch.cuda.empty_cache()
    dir2 = runs / "smoke" / "run2"
    check([s for s, _, _ in run2.steps] == list(range(TRAINER_SAVE_EVERY + 1,
                                                      TRAINER_STEPS + 1)),
          f"run 2 logged steps {[s for s, _, _ in run2.steps]}")
    got = file_digests(checkpoint_files(dir2, last))
    check(got == want, f"the resumed run's final checkpoint differs from run 1's: {got} {want}")
    l1, l2 = run1.losses(), run2.losses()
    check(all(l2[s] == l1[s] for s in l2), f"resumed losses {l2} != run 1's {l1}")
    for p in checkpoint_files(dir1, mid) + checkpoint_files(dir2, last):
        p.unlink()

    # gradient accumulation: fp32 mean into the kernels on emit steps only
    acc_cfg = merge(load_with_defaults(cfg_path), Config({
        "trainer": {"accumulate_grad_batches": ACCUM_K, "max_steps": ACCUM_MICRO_STEPS},
        "checkpoint": {"every_n_train_steps": None}}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer = Trainer(acc_cfg, runs / "accum", device=DEVICE)
    digests = [leaf_digests(trainer)]
    trainer.fit(sample_callback=lambda tr, step: digests.append(leaf_digests(tr)),
                final_save=False)
    torch.cuda.synchronize()
    acc_launches = read_launches()
    acc_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    acc_groups = optimizer_launches(trainer.state.opt_state.inner)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    moved = [int((a != b).sum()) for a, b in zip(digests, digests[1:])]
    n_leaves = len(digests[0])
    for i, m in enumerate(moved, start=1):
        emit = i % ACCUM_K == 0
        check(m > n_leaves // 2 if emit else m == 0,
              f"accumulation micro-step {i}: {m} of {n_leaves} masters moved")
    emits = ACCUM_MICRO_STEPS // ACCUM_K
    for name, n in acc_groups.items():
        check(acc_launches[name] == n * emits,
              f"{name} launched {acc_launches[name]} times in {emits} emits, expected {n} each")

    steady = [m["steps_per_sec"] for s, m, _ in run1.steps if s not in (1, TRAINER_SAVE_EVERY + 1)]
    return {"model_write_s": write_s, "steps": TRAINER_STEPS,
            "losses": [run1.losses()[s] for s in sorted(run1.losses())],
            "resumed_losses": [l2[s] for s in sorted(l2)],
            "steps_per_sec": [m["steps_per_sec"] for _, m, _ in run1.steps],
            "steady_steps_per_s": float(np.median(steady)), "train_phase_steps_per_s": train_rate,
            "first_step_s": run1.steps[0][2], "resume_first_step_s": run2.steps[0][2],
            "save_s": run1.saves + run2.saves, "resume_s": run2.resumes,
            "checkpoint_gib": ckpt_bytes / 2 ** 30, "peak_mem_gib": peak,
            "launches": launches,
            "launches_per_step": {k: v / TRAINER_STEPS for k, v in launches.items()},
            "resume_bit_equal": True,
            "accumulation": {"k": ACCUM_K, "micro_steps": ACCUM_MICRO_STEPS,
                             "masters_moved": moved, "of": n_leaves,
                             "launches": acc_launches, "peak_mem_gib": acc_peak}}


TUNER_HUB_ID = "smoke/sd15"      # the trainer phase's directory, as a cached hub id
TUNER_INIT_BATCH = 32            # 32 fits, 64 does not (PERF.md 5); from 32 for time
TUNER_PROBE_STEPS = 3            # tuner.subprocess_trial's steps per trial
TUNER_MAX_BATCH = 256            # the cache holds TUNER_PROBE_STEPS x this many rows
TUNER_STEPS = 2                  # steps at the picked batch
# the tuner over a world of 2 ranks sharing the card over gloo (the host's
# batch split over data 2): 32 rows fit (2 x 16, ~25 GiB a rank), 64 do not
TUNER_WORLD_RANKS = 2
TUNER_WORLD_INIT = 32
TUNER_WORLD_TIMEOUT = 600


def write_hub_cache(root: Path, model: Path, hub_id: str) -> Path:
    """An HF hub cache under ``root`` holding ``hub_id`` at its main ref, the
    snapshot a link to ``model``: the layout huggingface_hub writes."""
    org, name = hub_id.split("/")
    repo = root / f"models--{org}--{name}"
    rev = hashlib.sha1(hub_id.encode()).hexdigest()
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(rev)
    (repo / "snapshots").mkdir()
    (repo / "snapshots" / rev).symlink_to(model.resolve(), target_is_directory=True)
    return repo / "snapshots" / rev


def write_row_cache(path: Path, rows: int, seed: int) -> None:
    """A condition cache of ``rows`` seeded SD1.5 rows at 512^2: bf16
    latents (64, 64, 4) and conds (77, 768), about 150 kB a row."""
    gen = torch.Generator().manual_seed(seed)
    cache, metadata = assemble_cache({
        "ids": list(range(rows)),
        "latents": [torch.randn(rows, 64, 64, 4, generator=gen).bfloat16()],
        "conds": torch.randn(rows, 77, 768, generator=gen).bfloat16()})
    save_state_dict(cache, path, "safetensors", metadata={"json": json.dumps(metadata)})


def tuner_phase(seed: int, workdir: Path, model: Path, per_step: dict[str, int]) -> dict:
    """``trainer.auto_scale_batch_size: power`` through the train CLI at SD1.5
    full width: ``model:`` is a hub id that resolves through an HF cache
    written here (HF_HUB_CACHE, inherited by the probes) to ``model``, the
    trainer phase's directory; the trainer phase's config (AdamW, bf16
    masters and moments, 512^2) from TUNER_INIT_BATCH over a cache of seeded rows large
    enough that every trial's probe steps are real steps (a batch larger
    than the cache would end a drop_last epoch without one). Each trial is
    a probe subprocess; then TUNER_STEPS steps in this process at the
    picked batch, counted: each splash kernel 10 launches per step,
    adam_bf16_fused one per step."""
    hub = workdir / "hf_hub"
    snapshot = write_hub_cache(hub, model, TUNER_HUB_ID)
    cache_path = workdir / "tuner_cache.safetensors"
    rows = TUNER_PROBE_STEPS * TUNER_MAX_BATCH
    t0 = time.perf_counter()
    write_row_cache(cache_path, rows, seed + 15)
    cache_s = time.perf_counter() - t0
    config = trainer_config(TUNER_HUB_ID, workdir / "tune", cache_path, seed)
    config["batch_size"] = TUNER_INIT_BATCH
    config["trainer"] = dict(config["trainer"], auto_scale_batch_size="power", max_epochs=1,
                             max_steps=TUNER_STEPS)
    config["checkpoint"] = dict(config["checkpoint"], every_n_train_steps=None)
    cfg_path = workdir / "tuner.yaml"
    cfg_path.write_text(json.dumps(config))
    per_step = {**per_step, "adam_bf16_fused": ADAM_PER_STEP, "adam8_fused": 0, "ema_fused": 0}

    trials, digests = [], []
    real_trial, real_fit = tuner.subprocess_trial, Trainer.fit

    def recording_trial(*args, **kwargs):
        trials.append(real_trial(*args, **kwargs))
        return trials[-1]

    def digesting_fit(tr, *args, **kwargs):
        digests.append(leaf_digests(tr))
        out = real_fit(tr, *args, **kwargs)
        digests.append(leaf_digests(tr))
        return out

    env_before = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = str(hub)
    tuner.subprocess_trial, Trainer.fit = recording_trial, digesting_fit
    try:
        check(cached_snapshot(TUNER_HUB_ID) == snapshot,
              f"{TUNER_HUB_ID} does not resolve to {snapshot}")
        parent_gib = torch.cuda.memory_reserved() / 2 ** 30
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reset_launches()
        with TrainerProbe() as run:
            train_cli.main(["--config", str(cfg_path), "--run-id", "tuned", "--device", DEVICE],
                           standalone_mode=False)
        torch.cuda.synchronize()
        launches = read_launches()
        total_s = time.perf_counter() - t0
    finally:
        tuner.subprocess_trial, Trainer.fit = real_trial, real_fit
        if env_before is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = env_before
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    history = trials[0].history
    fits = [t["batch_size"] for t in history if t["fits"]]
    ooms = [t for t in history if t["returncode"] == tuner.PROBE_OOM]
    picked = int(load_with_defaults(workdir / "tune" / "smoke" / "tuned" / "config.yaml")
                 .batch_size)
    check(fits and ooms, f"the trials need a fit and an OOM: {history}")
    check(any("CUDA out of memory" in t.get("error", "") for t in ooms),
          f"no OOM exit with the allocator's CUDA out-of-memory error: {ooms}")
    check(all(t["steps"] == TUNER_PROBE_STEPS for t in history
              if t["returncode"] == tuner.PROBE_OK),
          f"a fit without {TUNER_PROBE_STEPS} real steps: {history}")
    check(picked == max(fits) and all(b == TUNER_INIT_BATCH * 2 ** i for i, b in enumerate(fits))
          and min(t["batch_size"] for t in ooms) == 2 * max(fits),
          f"picked {picked}, not the largest power of two that fit: {history}")
    check([s for s, _, _ in run.steps] == list(range(1, TUNER_STEPS + 1)),
          f"the tuned run logged steps {[s for s, _, _ in run.steps]}")
    check(all(math.isfinite(x) for x in run.losses().values()), f"losses {run.losses()}")
    for name, n in per_step.items():
        check(launches[name] == n * TUNER_STEPS,
              f"{name} launched {launches[name]} times in {TUNER_STEPS} tuned steps, expected "
              f"{n} per step")
    moved = int((digests[0] != digests[-1]).sum())
    check(moved > len(digests[0]) // 2, f"{moved} of {len(digests[0])} masters moved")
    shutil.rmtree(workdir / "tune")
    cache_path.unlink()
    # MFU of the last step at the pick (the first one warms up)
    step_flops = flops.train_step_flops(UNetConfig.sd15(), picked, 64)
    peak_flops = flops.GPU_PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    rate = run.steps[-1][1]["steps_per_sec"]
    return {"model_flops_per_step": step_flops,
            "mfu_last_step": step_flops * rate / peak_flops if peak_flops else None,
            "hub_id": TUNER_HUB_ID, "snapshot": str(snapshot), "cache_rows": rows,
            "cache_write_s": cache_s, "init_batch": TUNER_INIT_BATCH, "trials": history,
            "picked": picked, "seconds": total_s, "parent_reserved_gib": parent_gib,
            "steps": TUNER_STEPS, "losses": [run.losses()[s] for s in sorted(run.losses())],
            "steps_per_sec": [m["steps_per_sec"] for _, m, _ in run.steps],
            "peak_mem_gib": peak, "masters_moved": moved, "of": len(digests[0]),
            "launches": launches}


def tune_rank(out: str, cli_args: list[str]) -> None:
    """One rank of the tuner world: the train CLI under
    ``torch.distributed.run`` as a user runs it (no process group before it,
    so rank 0 runs the search before any exists), the launch counts reset
    just before it. Writes what the rank saw: the batch its Trainer was
    built with, its steps and losses, launches, peak memory, and on rank 0
    each trial (a world of probe ranks) and whether this process held a
    process group or a CUDA context while the trials ran."""
    from scal_sdt_tpu_torch.parallel.mesh import LaunchEnv

    env = LaunchEnv.from_environ()
    seen: dict = {"trials": [], "group_during_trials": [], "cuda_during_trials": []}
    real_trial, real_fit = tuner.subprocess_trial, Trainer.fit

    def recording_trial(*args, **kwargs):
        run = real_trial(*args, **kwargs)

        def trial(bs):
            seen["group_during_trials"].append(torch.distributed.is_initialized())
            seen["cuda_during_trials"].append(torch.cuda.is_initialized())
            return run(bs)
        trial.history = seen["trials"] = run.history
        return trial

    def fit(tr, *args, **kwargs):
        seen["batch_size"] = int(tr.config.batch_size)
        seen["mesh"] = list(tr.mesh.shape)
        seen["backend"] = torch.distributed.get_backend()
        return real_fit(tr, *args, **kwargs)

    tuner.subprocess_trial, Trainer.fit = recording_trial, fit
    try:
        reset_launches()
        with TrainerProbe() as probe:
            t0 = time.perf_counter()
            train_cli.main(cli_args, standalone_mode=False)
            seen["cli_s"] = time.perf_counter() - t0
    finally:
        tuner.subprocess_trial, Trainer.fit = real_trial, real_fit
    seen.update(world=env.world, rank=env.rank, launches=read_launches(),
                losses=probe.losses(), steps=[s for s, _, _ in probe.steps],
                steps_per_s=[m["steps_per_sec"] for _, m, _ in probe.steps],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    Path(f"{out}.rank{env.rank}.json").write_text(json.dumps(seen))


def tuner_world_phase(seed: int, workdir: Path, model: Path, per_step: dict[str, int]) -> dict:
    """``auto_scale_batch_size: power`` through the train CLI on a world of
    TUNER_WORLD_RANKS ranks (torchrun) sharing the card over gloo, at SD1.5
    full width: the trainer phase's config from TUNER_WORLD_INIT over a
    cache of seeded rows. Rank 0 runs one search while no rank holds a
    process group or a CUDA context; each trial is a world of as many probe
    ranks on the run's mesh (data 2: the host's batch split over the
    ranks), read from the ranks' reports; then every rank trains
    TUNER_STEPS steps at the one pick: each splash kernel 10 launches per
    step, adam_bf16_fused one per step, on each rank. Two ranks on
    one card check the mechanism, not speed on N cards."""
    here = Path(__file__).resolve()
    cache_path = workdir / "tuner_world_cache.safetensors"
    rows = TUNER_PROBE_STEPS * 2 * TUNER_WORLD_INIT
    write_row_cache(cache_path, rows, seed + 16)
    config = trainer_config(str(model), workdir / "tune_world", cache_path, seed)
    config["batch_size"] = TUNER_WORLD_INIT
    config["trainer"] = dict(config["trainer"], auto_scale_batch_size="power", max_epochs=1,
                             max_steps=TUNER_STEPS)
    config["checkpoint"] = dict(config["checkpoint"], every_n_train_steps=None)
    cfg_path = workdir / "tuner_world.yaml"
    cfg_path.write_text(json.dumps(config))
    out = workdir / "tuner_world"
    gc.collect()
    torch.cuda.empty_cache()
    parent_gib = torch.cuda.memory_reserved() / 2 ** 30
    t0 = time.perf_counter()
    proc = torchrun(TUNER_WORLD_RANKS, [str(here), "--tune-rank", str(out), "--",
                                        "--config", str(cfg_path), "--run-id", "tuned",
                                        "--device", "cuda:0", "--backend", "gloo"],
                    workdir / "tuner_world.log", timeout=TUNER_WORLD_TIMEOUT)
    seconds = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(workdir / "tuner_world.log", OUT_DIR / "tuner_world.log")
    errors = [ln for ln in (workdir / "tuner_world.log").read_text().splitlines()
              if "Error" in ln and "ChildFailedError" not in ln]
    check(proc.returncode == 0, "the tuner world failed (its log: "
          f"{OUT_DIR / 'tuner_world.log'}):\n" + "\n".join(errors[:20]))
    ranks = [json.loads(Path(f"{out}.rank{r}.json").read_text())
             for r in range(TUNER_WORLD_RANKS)]
    history = ranks[0]["trials"]
    picked = int(load_with_defaults(workdir / "tune_world" / "smoke" / "tuned" / "config.yaml")
                 .batch_size)
    fits = [t["batch_size"] for t in history if t["fits"]]
    ooms = [t for t in history if not t["fits"]]
    check(fits and ooms and all(len(t["ranks"]) == TUNER_WORLD_RANKS and
                                t["steps"] == TUNER_PROBE_STEPS for t in history
                                if t["fits"]),
          f"the world trials need a fit on every rank and an OOM: {history}")
    check(any("CUDA out of memory" in (t.get("error") or "") for t in ooms),
          f"no world trial ended in the allocator's CUDA out-of-memory error: {ooms}")
    check(picked == max(fits) and all(b == TUNER_WORLD_INIT * 2 ** i for i, b in enumerate(fits))
          and min(t["batch_size"] for t in ooms) == 2 * max(fits),
          f"picked {picked}, not the largest power of two that fit: {history}")
    check(not any(ranks[0]["group_during_trials"]) and not any(ranks[0]["cuda_during_trials"]),
          f"rank 0 held a process group or a CUDA context during the trials: {ranks[0]}")
    check(all(r["trials"] == [] for r in ranks[1:]), "a rank other than 0 ran trials")
    for r in ranks:
        check(r["batch_size"] == picked and r["world"] == TUNER_WORLD_RANKS
              and r["backend"] == "gloo" and r["mesh"] == [TUNER_WORLD_RANKS, 1, 1],
              f"rank {r['rank']} trained at {r['batch_size']} on {r['mesh']} over "
              f"{r['backend']}, not the pick {picked}")
        for name, n in per_step.items():
            check(r["launches"][name] == n * TUNER_STEPS,
                  f"rank {r['rank']}: {name} launched {r['launches'][name]} times in "
                  f"{TUNER_STEPS} steps, expected {n} per step")
    check(ranks[0]["steps"] == list(range(1, TUNER_STEPS + 1))
          and all(math.isfinite(x) for x in ranks[0]["losses"].values()),
          f"rank 0 logged steps {ranks[0]['steps']}, losses {ranks[0]['losses']}")
    shutil.rmtree(workdir / "tune_world")
    cache_path.unlink()
    return {"note": "two ranks on one card over gloo: the mechanism, not speed on N cards",
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]},
            "init_batch": TUNER_WORLD_INIT, "trials": history, "picked": picked,
            "seconds": seconds, "parent_reserved_gib": parent_gib, "ranks": ranks}


CUSTOM_STEPS = 3            # Custom Diffusion steps through the train CLI
# the splash self-attentions with a trained K/V upstream, so with a
# backward: all but the first (down_blocks.0.attentions.0.attn1 precedes
# the first cross-attention)
CUSTOM_BWD_PER_STEP = CALLS_PER_STEP - 1
CUSTOM_LR = 1e-4            # fp32 masters: 3 Adam steps move every K/V weight past an fp16 ulp


def custom_diffusion_phase(seed: int, workdir: Path, model: Path, cache_path: Path) -> dict:
    """BASELINE workload 5 at SD1.5 full width: the ``custom_diffusion``
    optim target (the 32 cross-attention K/V projections, one group each)
    through the train CLI, CUSTOM_STEPS cached steps of batch 8 at 512^2
    from the trainer phase's directory and cache, AdamW with fp32 masters;
    each splash kernel's launches counted (forward CALLS_PER_STEP per step;
    the backward CUSTOM_BWD_PER_STEP, only where a trained K/V lies
    upstream), adam_bf16_fused one per step over the 32 groups. Its checkpoint holds only the
    32 trained leaves.
    ``ckpt_tool prune --arch sd1 --unet-dtype fp16`` of it writes the
    partial WebUI file: the 32 K/V weights under model.diffusion_model.,
    fp16, each the trained master rounded to fp16. The trained leaves over
    the directory's UNet with its CLIP, pruned with ``--text-encoder
    --df-vae <dir>/vae --unet-dtype fp16``, give the whole WebUI file;
    ``convert/loader.py`` ``load_ldm_checkpoint`` reloads it: every UNet
    tensor is the directory's rounded to fp16, but the 32 K/V, which are
    the trained weights rounded to fp16 (equal to the partial file's)."""
    from scal_sdt_tpu_torch.cli import ckpt_tool

    t_phase = time.perf_counter()
    config = trainer_config(str(model), workdir / "custom_runs", cache_path, seed)
    config.update(optim_target="custom_diffusion")
    config["trainer"] = dict(config["trainer"], max_steps=CUSTOM_STEPS, max_epochs=2)
    config["optimizer"] = dict(config["optimizer"], master_dtype="fp32", moment_dtype=None,
                               params={"lr": CUSTOM_LR, "weight_decay": 1e-2})
    config["checkpoint"] = dict(config["checkpoint"], filename="last", every_n_train_steps=None)
    cfg_path = workdir / "custom_diffusion.yaml"
    cfg_path.write_text(json.dumps(config))
    shapes = unet_param_shapes(UNetConfig.sd15())
    res = resolve_optim_target(load_optim_target("custom_diffusion"), shapes, [])["unet"]
    kv = {f"unet.{k}" for k in res.trainable}
    check(len(kv) == 32 and len(res.groups) == 32
          and all(".attn2.to_k." in k or ".attn2.to_v." in k for k in kv),
          f"custom_diffusion resolves to {len(kv)} leaves in {len(res.groups)} groups")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as run:
        t0 = time.perf_counter()
        train_cli.main(["--config", str(cfg_path), "--run-id", "cd", "--device", DEVICE],
                       standalone_mode=False)
        train_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = run.losses()
    check(sorted(losses) == list(range(1, CUSTOM_STEPS + 1))
          and all(math.isfinite(x) for x in losses.values()), f"custom diffusion losses {losses}")
    check(launches["splash_fwd"] == CALLS_PER_STEP * CUSTOM_STEPS
          and launches["splash_dq"] == launches["splash_dkv"]
          == CUSTOM_BWD_PER_STEP * CUSTOM_STEPS
          and launches["adam_bf16_fused"] == ADAM_PER_STEP * CUSTOM_STEPS
          and launches["adam8_fused"] == launches["ema_fused"] == 0,
          f"custom diffusion launches {launches}")
    ckpt = workdir / "custom_runs" / "smoke" / "cd" / "last.safetensors"
    trained = load_state_dict(ckpt)
    check(set(trained) == kv and all(v.dtype == torch.float32 for v in trained.values()),
          f"the Custom Diffusion checkpoint holds {len(trained)} tensors, not the 32 K/V")

    t0 = time.perf_counter()
    partial = workdir / "custom_kv_fp16.safetensors"
    ckpt_tool.main(["prune", str(ckpt), str(partial), "--arch", "sd1", "--unet-dtype", "fp16"],
                   standalone_mode=False)
    partial_s = time.perf_counter() - t0
    kv_file = load_state_dict(partial)
    check(len(kv_file) == 32 and all(k.startswith("model.diffusion_model.") and
                                     v.dtype == torch.float16 for k, v in kv_file.items()),
          f"the partial WebUI file: {sorted(kv_file)[:3]}")
    check(sorted(v.contiguous().view(torch.int16).sum(dtype=torch.int64).item()
                 for v in kv_file.values())
          == sorted(v.half().contiguous().view(torch.int16).sum(dtype=torch.int64).item()
                    for v in trained.values()),
          "the partial WebUI file's K/V are not the trained weights rounded to fp16")

    base = load_components(merge(default(), Config({"model": str(model)})))
    training = {**{f"unet.{k}": v for k, v in base.unet.items()},
                **{f"condition_model.encoder.{k}": v for k, v in base.clip.items()}}
    training.update(trained)
    train_file, full = workdir / "custom_train.safetensors", workdir / "custom_fp16.safetensors"
    save_state_dict(training, train_file)
    del training
    t0 = time.perf_counter()
    ckpt_tool.main(["prune", str(train_file), str(full), "--text-encoder", "--df-vae",
                    str(model / "vae"), "--unet-dtype", "fp16"], standalone_mode=False)
    full_s = time.perf_counter() - t0
    train_file.unlink()
    t0 = time.perf_counter()
    reloaded = load_ldm_checkpoint(full)
    load_s = time.perf_counter() - t0
    check(reloaded.unet_config == UNetConfig.sd15() and reloaded.unet.keys() == base.unet.keys(),
          "the reloaded Custom Diffusion file's UNet")
    differ, moved, kv_equal = [], 0, 0
    for k, v in reloaded.unet.items():
        want = trained[f"unet.{k}"] if f"unet.{k}" in kv else base.unet[k]
        if not torch.equal(v.to(torch.float16).cpu(), want.to(torch.float16).cpu()):
            differ.append(k)
        if f"unet.{k}" in kv:
            moved += int(not torch.equal(v.to(torch.float16).cpu(),
                                         base.unet[k].to(torch.float16).cpu()))
    check(not differ, f"{len(differ)} reloaded UNet tensors differ from the base or the trained "
          f"weights rounded to fp16, e.g. {differ[:3]}")
    check(moved == len(kv), f"{moved} of {len(kv)} K/V weights differ from the base in fp16")
    del base, reloaded
    sizes = {"checkpoint_mib": ckpt.stat().st_size / 2 ** 20,
             "partial_kib": partial.stat().st_size / 2 ** 10,
             "full_gib": full.stat().st_size / 2 ** 30}
    for path in (partial, full):
        path.unlink()
    shutil.rmtree(workdir / "custom_runs")
    return {"optim_target": "custom_diffusion", "leaves": len(kv), "groups": len(res.groups),
            "splash_bwd_per_step": CUSTOM_BWD_PER_STEP,
            "steps": CUSTOM_STEPS, "losses": [losses[i] for i in sorted(losses)],
            "steps_per_s": [m["steps_per_sec"] for _, m, _ in run.steps], "train_s": train_s,
            "peak_mem_gib": peak, "launches": launches, **sizes,
            "partial_prune_s": partial_s, "full_prune_s": full_s, "reload_s": load_s,
            "kv_moved": moved, "seconds": time.perf_counter() - t_phase}


def tensor_digests(tensors) -> torch.Tensor:
    """One int64 per tensor: the sum of its bit patterns (as int16 or int32),
    which moves when any of its elements does (almost surely)."""
    return torch.stack([t.view(torch.int16 if t.element_size() == 2 else torch.int32)
                        .sum(dtype=torch.int64) for t in tensors])


EMA_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}   # the EMA phase's shadows
EMA_DECAY = 0.995
EMA_OPS = 3              # fp32 operations per element: subtract, multiply, subtract


def ema_bytes(table) -> int:
    """Bytes one EMA launch over ``table`` must move: each shadow read and
    written, each master read."""
    return sum(s.numel() * (2 * s.element_size() + m.element_size())
               for s, m in zip(table.shadows, table.masters))


def ema_kernel_case(gen: torch.Generator, keys, shapes, s_dtype: torch.dtype) -> dict:
    """The grouped EMA kernel in one launch over all 686 SD1.5 leaves (bf16
    masters, shadows of ``s_dtype`` off the masters) against
    ema_fused_apply_reference, bit for bit; the times of both, the bytes
    bound, and torch._foreach_lerp_ over fp32 shadows and fp32 copies of the
    masters (the same function for fp32 masters) as the yardstick."""
    masters = [rand(s, gen, 2e-2) for s in shapes]
    shadows = [(m.float() + rand(s, gen, 1e-3, torch.float32)).to(s_dtype)
               for m, s in zip(masters, shapes)]
    one_minus, step = one_minus_decay(EMA_DECAY, 9), 8
    got = ema_fused.build_ema_table(keys, clones(shadows), masters)
    want = ema_fused.build_ema_table(keys, clones(shadows), masters)
    ema_fused.ema_fused_apply(got, one_minus, step)
    ema_fused.ema_fused_apply_reference(want, one_minus, step)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got.shadows, want.shadows))
    err = max(max_abs(a, b) for a, b in zip(got.shadows, want.shadows))
    check(equal, f"ema_fused ({s_dtype} shadows) disagrees with its plain version: {err}")
    moved = sum(not torch.equal(a, b) for a, b in zip(got.shadows, shadows))
    check(moved == len(keys), f"ema_fused moved {moved} of {len(keys)} shadows")
    n = sum(t.numel() for t in shadows)
    nbytes = ema_bytes(got)
    res = {"shadow": str(s_dtype), "leaves": len(keys), "elements": n, "bit_equal": equal,
           "max_abs_err": err,
           "ms": kernel_device_ms(lambda: ema_fused.ema_fused_apply(got, one_minus, step),
                                  "ema_group"),
           "call_ms": time_ms(lambda: ema_fused.ema_fused_apply(got, one_minus, step)),
           "plain_ms": time_ms(lambda: ema_fused.ema_fused_apply_reference(want, one_minus, step),
                               iters=1, warmup=0),
           "bytes": nbytes, "bound": list(bound(nbytes, EMA_OPS * n))}
    del got, want, shadows
    torch.cuda.empty_cache()
    s32 = [rand(s, gen, 2e-2, torch.float32) for s in shapes]
    m32 = [m.float() for m in masters]
    res["library_ms"] = device_ms(lambda: torch._foreach_lerp_(s32, m32, one_minus), iters=10,
                                  warmup=2)
    res["library"] = ("torch._foreach_lerp_ over fp32 shadows and fp32 copies of the masters "
                      "(the same function for fp32 masters)")
    return res


def ema_phase(seed: int, steps: int, per_step: dict[str, int], train_rate: float,
              warmup: int = 3) -> dict:
    """The EMA kernel over the SD1.5 leaves (both shadow dtypes), then the
    cached SD1.5 full fine-tune (the train phase's step) with EMA on, an fp32
    shadow and then a bf16 one: ``warmup`` and ``steps`` timed steps each,
    ema_fused once per step beside the train phase's launches, the shadows
    moving. Then 4 micro-steps at accumulate_grad_batches 2 from the bf16
    run's state: the EMA runs and moves on all four, the masters on the
    emits only."""
    keys, shapes = sd15_leaves()
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    res: dict = {"kernel": {name: ema_kernel_case(gen, keys, shapes, dt)
                            for name, dt in EMA_DTYPES.items()}, "train_phase_steps_per_s": train_rate}
    gc.collect()
    torch.cuda.empty_cache()
    for name in EMA_DTYPES:
        setup = setup_train(seed, "adamw", {"ema": {"enabled": True, "dtype": name,
                                                    "decay": EMA_DECAY}})
        state, step_fn, batch = setup["state"], setup["step_fn"], setup["batch"]
        expect = {**per_step, **optimizer_launches(state.opt_state), "ema_fused": 1}
        shadow0 = tensor_digests(state.ema.shadow.values())
        run = run_steps(state, step_fn, {}, lambda: batch, steps, warmup, expect)
        state = run.pop("state")
        check(state.ema.num_updates == warmup + steps,
              f"{state.ema.num_updates} EMA updates in {warmup + steps} steps")
        moved = int((tensor_digests(state.ema.shadow.values()) != shadow0).sum())
        check(moved > len(keys) // 2, f"{moved} of {len(keys)} shadows moved")
        tables = list(state.ema.tables.values())
        check(len(tables) == 1, f"{len(tables)} EMA tables for one shadow and master dtype")
        one_minus = one_minus_decay(EMA_DECAY, state.ema.num_updates)
        run["ema_ms_per_step"] = device_ms(
            lambda: [ema_fused.ema_fused_apply(t, one_minus, state.step) for t in tables],
            iters=10, warmup=1)
        run["launches_per_step"] = {k: v / steps for k, v in run["launches"].items()}
        run["counted_launches_per_step"] = sum(run["launches_per_step"].values())
        run["shadows_moved"] = moved
        if name == "bf16":
            run["accumulation"] = ema_accumulation(setup, state, batch, len(keys))
        res[name] = run
        del setup, state, step_fn, tables
        gc.collect()
        torch.cuda.empty_cache()
    res["launches"] = res["fp32"]["launches"]
    return res


def ema_accumulation(setup: dict, state, batch: dict, n_leaves: int) -> dict:
    """ACCUM_MICRO_STEPS micro-steps at accumulate_grad_batches ACCUM_K from
    ``state`` (its shadows lag its masters): the masters move on emits only,
    the EMA shadows on every micro-step, ema_fused once each."""
    acc_tx = GradientAccumulation(setup["tx"], ACCUM_K)
    acc = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in state.trainable.items()}
    state = state._replace(opt_state=AccumulationState(0, state.opt_state, acc))
    step_fn = make_train_step(setup["spec"], acc_tx, setup["lr_fn"], ema_enabled=True)
    n0 = state.ema.num_updates
    torch.cuda.synchronize()
    reset_launches()
    prev = (tensor_digests(state.trainable.values()), tensor_digests(state.ema.shadow.values()))
    masters_moved, shadows_moved = [], []
    for _ in range(ACCUM_MICRO_STEPS):
        state, metrics = step_fn(state, {}, batch)
        now = (tensor_digests(state.trainable.values()), tensor_digests(state.ema.shadow.values()))
        masters_moved.append(int((now[0] != prev[0]).sum()))
        shadows_moved.append(int((now[1] != prev[1]).sum()))
        check(math.isfinite(float(metrics["train_loss"])), "non-finite loss under accumulation")
        prev = now
    launches = read_launches()
    emits = ACCUM_MICRO_STEPS // ACCUM_K
    for i, (m, sh) in enumerate(zip(masters_moved, shadows_moved), start=1):
        emit = i % ACCUM_K == 0
        check(m > n_leaves // 2 if emit else m == 0,
              f"EMA accumulation micro-step {i}: {m} of {n_leaves} masters moved")
        check(sh > n_leaves // 2, f"EMA accumulation micro-step {i}: {sh} shadows moved")
    check(state.ema.num_updates == n0 + ACCUM_MICRO_STEPS,
          f"{state.ema.num_updates - n0} EMA updates in {ACCUM_MICRO_STEPS} micro-steps")
    check(launches["ema_fused"] == ACCUM_MICRO_STEPS
          and launches["adam_bf16_fused"] == ADAM_PER_STEP * emits,
          f"launches under accumulation: {launches}")
    return {"k": ACCUM_K, "micro_steps": ACCUM_MICRO_STEPS, "masters_moved": masters_moved,
            "shadows_moved": shadows_moved, "of": n_leaves, "launches": launches}


LORA_STEPS, LORA_SAVE_EVERY = 6, 4   # run 1, and its mid-epoch checkpoint that run 2 resumes
LORA_EMA_STEPS, LORA_DROPOUT = 2, 0.1  # run 3: dropout and a bf16 EMA shadow
LORA_PRODIGY_STEPS, LORA_PRODIGY_SAVE = 4, 2   # the lora_prodigy phase's run 1 and its resume


def splash_levels(shape_bhwc, unet_config: UNetConfig, vae_factor: int = 8
                  ) -> list[tuple[tuple[int, int, int, int], int]]:
    """For images of (B, H, W, C): the (B, heads, h*w, D) of each UNet level's
    self-attention and the calls per UNet forward that take the splash
    kernels there. A level with attention holds layers_per_block (down) +
    layers_per_block + 1 (up) transformers, the middle block one at the last
    level's width, each of tf_depth_at(level) blocks with one self-attention
    (SD1.5: 1 everywhere; SDXL: 1, 2, 10); a call takes the kernels where the
    gate (ops/attention.py) admits its shape."""
    b, hh, ww, _ = shape_bhwc
    h, w = hh // vae_factor, ww // vae_factor
    cfg, out = unet_config, []
    levels = len(cfg.block_out_channels)
    for level, ch in enumerate(cfg.block_out_channels):
        heads = cfg.heads_at(level)
        shape = (b, heads, h * w, ch // heads)
        takes = attention.use_kernel(shape, shape, torch.bfloat16, False, True)
        transformers = 0
        if "CrossAttn" in cfg.down_block_types[level]:
            transformers += cfg.layers_per_block
        if "CrossAttn" in cfg.up_block_types[levels - 1 - level]:
            transformers += cfg.layers_per_block + 1
        if level == levels - 1:
            transformers += 1   # the middle block
        out.append((shape, takes * transformers * cfg.tf_depth_at(level)))
        h, w = -(-h // 2), -(-w // 2)
    return out


def splash_calls(shape_bhwc, unet_config: UNetConfig) -> int:
    """Self-attention calls per UNet forward that take the splash kernels."""
    return sum(n for _, n in splash_levels(shape_bhwc, unet_config))


def step_shapes(timings: Path) -> list[list[int]]:
    """The batch shape (B, H, W, C) of each logged step (SSDT_STEP_TIMINGS)."""
    return [json.loads(line)["shape"] for line in timings.read_text().splitlines()]


def expect_train_splash(shapes, launches: dict, what: str, unet_config: UNetConfig,
                        vae_factor: int = 8, sampled: int = 0) -> int:
    """Check a remat run's splash launches against the gate at each step's
    batch shape (B, H, W, C) (``vae_factor`` 1: latents): each admitted
    self-attention runs its forward twice (the recompute) and dq, dkv once;
    sampled images' forwards on top. Returns the calls."""
    calls = sum(n for s in shapes for _, n in splash_levels(s, unet_config, vae_factor))
    want = {"splash_fwd": 2 * calls + sampled, "splash_dq": calls, "splash_dkv": calls}
    check(calls > 0 and all(launches[k] == v for k, v in want.items()),
          f"{what}: splash launches {launches}, expected {want} for shapes {shapes}")
    return calls


def lora_phase(seed: int, workdir: Path, model: Path, images: Path) -> dict:
    """configs/lora.yaml through the train CLI over the trainer phase's SD1.5
    directory: LoRA on the UNet and CLIP (rank 16), remat, ARB buckets from
    the 720x576 / 576x720 PNGs, batch 4, uncached. Run 1 trains LORA_STEPS
    steps with a checkpoint at LORA_SAVE_EVERY (mid-epoch) and at the end;
    run 2 resumes from the mid-epoch checkpoint and must end on run 1's final
    checkpoint and sidecar bit for bit. Run 3: LORA_EMA_STEPS steps with
    dropout LORA_DROPOUT on every LoRA module and a bf16 EMA shadow. The
    file's in-training sampling is on, cut to every LORA_SAMPLE_EVERY steps
    and LORA_SAMPLES images: run 1 samples once, at its mid-epoch step,
    before the checkpoint that run 2 resumes; the PNGs land in
    samples/<step>/, and run 2 still ends on run 1's bytes."""
    runs, timings = workdir / "lora_runs", workdir / "lora_timings.jsonl"
    base = load_with_defaults(CONFIGS_DIR / "lora.yaml")
    sample_concepts = [{**c, "num_samples": LORA_SAMPLES} for c in base.sampling.concepts]
    config = merge(base, Config({
        "model": str(model), "output_dir": str(runs), "project": "lora", "seed": seed,
        "num_workers": NUM_WORKERS,
        "data": {"concepts": [{"instance_set": {"path": str(images), "prompt": "{TXT_PROMPT}"}}]},
        "sampling": {"interval_steps": LORA_SAMPLE_EVERY, "concepts": sample_concepts},
        "trainer": {"max_steps": LORA_STEPS, "log_every_n_steps": 1},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None,
                       "every_n_train_steps": LORA_SAVE_EVERY, "monitor": None},
        "loggers": {"tensorboard": None}}))
    check(config.gradient_checkpointing is True and config.aspect_ratio_bucket.enabled
          and config.batch_size == 4 and config.optim_target == "lora", "lora.yaml changed")
    cfg_path = workdir / "lora.yaml"
    cfg_path.write_text(json.dumps(config))
    unet_config = UNetConfig.sd15()
    res_t = resolve_optim_target(load_optim_target("lora"), unet_param_shapes(unet_config),
                                 clip_param_shapes(CLIPTextConfig.vit_l()))
    groups = {comp: len(r.groups) for comp, r in res_t.items()}
    os.environ["SSDT_STEP_TIMINGS"] = str(timings)

    def cli(args, probe):
        with probe:
            train_cli.main(args + ["--device", DEVICE], standalone_mode=False)
        gc.collect()
        torch.cuda.empty_cache()

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run1 = TrainerProbe()
        with CallbackProbe() as sampling:
            cli(["--config", str(cfg_path), "--run-id", "run1"], run1)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        shapes1 = step_shapes(timings)
        check([s for s, _, _ in run1.steps] == list(range(1, LORA_STEPS + 1)),
              f"lora run 1 logged steps {[s for s, _, _ in run1.steps]}")
        check(all(math.isfinite(x) for x in run1.losses().values()), f"losses {run1.losses()}")
        check(len({tuple(s) for s in shapes1}) > 1 and all(s[1] != s[2] for s in shapes1),
              f"ARB buckets {shapes1}: expected non-square buckets of two orientations")
        sample_dir = runs / "lora" / "run1" / "samples"
        events = LORA_STEPS // LORA_SAMPLE_EVERY
        check([step for step, _ in sampling.events] ==
              [LORA_SAMPLE_EVERY * (i + 1) for i in range(events)]
              and sorted(p.name for p in sample_dir.iterdir()) ==
              sorted(str(step) for step, _ in sampling.events),
              f"lora run 1 sampled at {sampling.events}: {sorted(sample_dir.iterdir())}")
        size = (int(sample_concepts[0]["width"]), int(sample_concepts[0]["height"]))
        for step, _ in sampling.events:
            pngs = sorted((sample_dir / str(step)).glob("*.png"))
            check([p.name for p in pngs] == [f"0-{j}.png" for j in range(LORA_SAMPLES)],
                  f"lora run 1 samples at step {step}: {pngs}")
            for p in pngs:
                png_pixels(p, size)
        sampled = (events * LORA_SAMPLES * int(sample_concepts[0]["steps"])
                   * splash_calls((2, size[1], size[0], 3), unet_config))
        calls = expect_train_splash(shapes1, launches, "lora run 1", unet_config,
                                    sampled=sampled)
        n_groups = sum(groups.values())
        check(launches["adam_bf16_fused"] == ADAM_PER_STEP * LORA_STEPS
              and launches["ema_fused"] == 0
              and launches["adam8_fused"] == 0, f"lora run 1 launches {launches}")
        dir1 = runs / "lora" / "run1"
        mid, last = (f"epoch=0-step={n}" for n in (LORA_SAVE_EVERY, LORA_STEPS))
        check(sorted(p.name for p in dir1.glob("*.safetensors")) ==
              [mid + ".safetensors", last + ".safetensors"],
              f"lora run 1 wrote {sorted(p.name for p in dir1.iterdir())}")
        ckpt = load_state_dict(dir1 / f"{mid}.safetensors")
        factors = {k: v for k, v in ckpt.items() if k.endswith((".lora_A", ".lora_B"))}
        check(len(factors) == 2 * n_groups and len(ckpt) == 3 * n_groups,
              f"the LoRA checkpoint holds {len(ckpt)} tensors for {n_groups} modules")
        trainables = {comp: sum(v.numel() for k, v in factors.items()
                                if k.startswith(COMPONENT_PREFIX[comp] + "."))
                      for comp in groups}
        ckpt_bytes = (dir1 / f"{mid}.safetensors").stat().st_size
        sidecar_bytes = (dir1 / f"{mid}.safetensors.torchstate").stat().st_size
        want = file_digests(checkpoint_files(dir1, last))

        torch.cuda.synchronize()
        reset_launches()
        run2 = TrainerProbe()
        cli(["--resume", str(dir1 / f"{mid}.safetensors"), "--run-id", "run2"], run2)
        launches2 = read_launches()
        expect_train_splash(step_shapes(timings), launches2, "lora run 2", unet_config)
        check(launches2["adam_bf16_fused"] == ADAM_PER_STEP * (LORA_STEPS - LORA_SAVE_EVERY)
              and launches2["ema_fused"] == 0, f"lora run 2 launches {launches2}")
        got = file_digests(checkpoint_files(runs / "lora" / "run2", last))
        check(got == want, f"the resumed LoRA run's checkpoint differs from run 1's: {got} {want}")
        l1, l2 = run1.losses(), run2.losses()
        check(sorted(l2) == list(range(LORA_SAVE_EVERY + 1, LORA_STEPS + 1))
              and all(l2[s] == l1[s] for s in l2), f"resumed losses {l2} != run 1's {l1}")

        spec = json.loads(json.dumps(load_optim_target("lora")))
        for comp in ("unet", "text_encoder"):
            spec[comp]["targets"][0]["recurse_conf"]["lora"]["dropout"] = LORA_DROPOUT
        ema_cfg = merge(config, Config({
            "optim_target": spec, "ema": {"enabled": True, "dtype": "bf16"},
            "trainer": {"max_steps": LORA_EMA_STEPS},
            "checkpoint": {"every_n_train_steps": None}}))
        ema_path = workdir / "lora_ema.yaml"
        ema_path.write_text(json.dumps(ema_cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run3 = TrainerProbe()
        cli(["--config", str(ema_path), "--run-id", "run3"], run3)
        launches3 = read_launches()
        peak3 = torch.cuda.max_memory_allocated() / 2 ** 30
        check(all(math.isfinite(x) for x in run3.losses().values())
              and sorted(run3.losses()) == list(range(1, LORA_EMA_STEPS + 1)),
              f"lora run 3 losses {run3.losses()}")
        calls3 = expect_train_splash(step_shapes(timings), launches3, "lora run 3", unet_config)
        check(launches3["ema_fused"] == LORA_EMA_STEPS
              and launches3["adam_bf16_fused"] == ADAM_PER_STEP * LORA_EMA_STEPS,
              f"lora run 3 launches {launches3}")
        path3 = runs / "lora" / "run3" / f"epoch=0-step={LORA_EMA_STEPS}.safetensors"
        meta3 = json.loads(load_metadata(path3)["json"])
        shadow = [k for k in load_state_dict(path3) if k.startswith("unet_ema.shadow_params.")]
        check(meta3["ema_num_updates"] == LORA_EMA_STEPS and len(shadow) == 2 * groups["unet"],
              f"lora run 3 checkpoint: {meta3}, {len(shadow)} shadow tensors")
    finally:
        os.environ.pop("SSDT_STEP_TIMINGS", None)

    def rate(probe, skip):
        """Steps over the host's wall time they took (the time between their
        logs), the steps in ``skip`` left out: the first (the pipeline's
        warm-up) and the one that follows a checkpoint write."""
        dts = [1.0 / m["steps_per_sec"] for s, m, _ in probe.steps if s not in skip]
        return len(dts) / sum(dts)

    # the attention shapes that took the kernels at this run's buckets
    splash_shapes = sorted({shape for b in shapes1 for shape, n in splash_levels(b, unet_config)
                            if n})
    return {"steps": LORA_STEPS, "groups": groups, "trainable_params": trainables,
            "sampling": {"interval_steps": LORA_SAMPLE_EVERY, "num_samples": LORA_SAMPLES,
                         "events_s": sampling.events, "splash_fwd": sampled},
            "bucket_shapes": shapes1, "splash_shapes": splash_shapes,
            "losses": [l1[s] for s in sorted(l1)],
            "resumed_losses": [l2[s] for s in sorted(l2)], "resume_bit_equal": True,
            "steps_per_s": rate(run1, {1, LORA_SAVE_EVERY + 1}),
            "resumed_steps_per_s": rate(run2, {LORA_SAVE_EVERY + 1}),
            "first_step_s": run1.steps[0][2], "save_s": run1.saves, "resume_s": run2.resumes,
            "checkpoint_mib": ckpt_bytes / 2 ** 20, "sidecar_mib": sidecar_bytes / 2 ** 20,
            "peak_mem_gib": peak,
            # every launch of the phase: runs 1, 2 (resumed) and 3
            "launches": {k: launches[k] + launches2[k] + launches3[k] for k in launches},
            "run1_launches": launches, "run2_launches": launches2,
            # training's launches per step (run 1's sampling event left out)
            "launches_per_step": {k: (v - (sampled if k == "splash_fwd" else 0)) / LORA_STEPS
                                  for k, v in launches.items()},
            "splash_calls_per_step": calls / LORA_STEPS,
            "ema_dropout": {"steps": LORA_EMA_STEPS, "dropout": LORA_DROPOUT,
                            "losses": [run3.losses()[s] for s in sorted(run3.losses())],
                            "steps_per_s": rate(run3, {1}), "peak_mem_gib": peak3,
                            "launches": launches3,
                            "launches_per_step": {k: v / LORA_EMA_STEPS
                                                  for k, v in launches3.items()},
                            "splash_calls_per_step": calls3 / LORA_EMA_STEPS,
                            "ema_num_updates": meta3["ema_num_updates"]}}


def lora_groups(target: str = "lora", bases: dict | None = None
                ) -> list[tuple[str, list[str], list[tuple[int, ...]], dict]]:
    """An optim target's LoRA param groups (configs/lora.yaml's at SD1.5 width
    by default; ``bases``: component -> its param shapes), as the trainer
    holds them: one per LoRA module, with its component, its two factors'
    keys (as the trainer names them) and shapes, and the group's optimizer
    overrides; the UNet's groups first."""
    bases = bases or {"unet": unet_param_shapes(UNetConfig.sd15()),
                      "text_encoder": clip_param_shapes(CLIPTextConfig.vit_l())}
    metas = {comp: {k: torch.empty(v, device="meta") for k, v in shapes.items()}
             for comp, shapes in bases.items()}
    out = []
    for comp, r in resolve_optim_target(load_optim_target(target), bases["unet"],
                                        bases["text_encoder"],
                                        bases.get("text_encoder_2")).items():
        shapes = lora_factor_shapes(metas[comp], r.lora)
        out += [(comp, [f"{COMPONENT_PREFIX[comp]}.{k}" for k in g.keys],
                 [shapes[k] for k in g.keys], g.optimizer) for g in r.groups]
    return out


def lora_adam_case(gen: torch.Generator, groups, config) -> tuple[dict, dict]:
    """adam_bf16_fused as a LoRA run launches it: ``config``'s optimizer
    through build_optimizer over ``groups`` (each LoRA module its own param
    group with its lr and decay), fp32 masters and moments, bf16 gradients,
    one ``tx.update_and_apply`` per step: one launch over every group's
    leaves (the default AdamW: the xla rounding), bit for bit against the
    plain version of the same merged launch (``MergedLaunch``). Per step: the
    kernel's device time (``staged_device_ms``), the launch's time by CUDA
    events (the host's staging of the gradient addresses and group records
    included),
    the whole ``update_and_apply``'s host ms (its return, after a
    synchronize) and launches, the bytes bound of the same work and
    torch._fused_adamw_ over the same lists. Returns the record and the
    masters the kernel updated."""
    labels = {k: f"g{i:04d}" for i, (_, keys, _, _) in enumerate(groups) for k in keys}
    overrides = {f"g{i:04d}": opt for i, (_, _, _, opt) in enumerate(groups)}
    tx, _ = build_optimizer(config, labels, overrides, steps_per_epoch=1000, num_processes=1)
    shapes = {k: sh for _, keys, shs, _ in groups for k, sh in zip(keys, shs)}
    masters = {k: rand(sh, gen, 2e-2, torch.float32) for k, sh in shapes.items()}
    state = tx.init(masters)
    check(all(t.xla for t in tx.transforms.values()), "the LoRA run's AdamW is not in xla mode")
    for s in state.values():   # moments and a count as a run's after two steps
        for k in s.mu:
            s.mu[k].copy_(rand(shapes[k], gen, 1e-4, torch.float32))
            s.nu[k].copy_(rand(shapes[k], gen, 1e-7, torch.float32, positive=True))
        s.count = 2
    grads = {k: rand(sh, gen, 1e-3) for k, sh in shapes.items()}
    step = 2
    plain_masters = {k: v.clone() for k, v in masters.items()}
    plain_state = copy.deepcopy(state)
    (merged,) = tx.merged_launches(state, masters)
    b1, b2, eps, recip_bc, update_dtype, xla = merged.launch
    kw = dict(b1=b1, b2=b2, eps=eps, recip_bc=recip_bc, step=step, update_dtype=update_dtype,
              xla=xla)
    want = adam_bf16_fused.build_adam_table(
        merged.keys, *merged.tensors(tx.transforms, plain_state, plain_masters))
    steps = [tx.transforms[label].group_step(plain_state[label].count)
             for label in merged.labels]
    flat_grads = [grads[k] for keys in merged.keys for k in keys]
    torch.cuda.synchronize()
    reset_launches()
    tx.update_and_apply(grads, state, masters, step)
    launches = read_launches()
    adam_bf16_fused.adam_bf16_fused_apply_reference(want, flat_grads, steps, **kw)
    torch.cuda.synchronize()
    got = merged.table
    check(launches["adam_bf16_fused"] == 1 and len(got.keys) == len(groups),
          f"the LoRA optimizer step over {len(groups)} groups launched {launches}")
    err = {what: all(torch.equal(a, b) for a, b in zip(getattr(got, what), getattr(want, what)))
           for what in ("params", "mu", "nu")}
    err["out"] = max(max_abs(a, b) for a, b in zip(got.params, want.params))
    check(err["params"] and err["mu"] and err["nu"],
          f"adam_bf16_fused over the LoRA groups (fp32 masters and moments) disagrees: {err}")
    check(len({st.step_size for st in steps}) == len({o.get("lr") for o in overrides.values()}),
          "the LoRA groups' step sizes")

    def run():
        adam_bf16_fused.adam_bf16_fused_apply(got, flat_grads, steps, **kw)

    host = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.update_and_apply(grads, state, masters, step + 1 + i)
        host.append((time.perf_counter() - t0) * 1e3)
    n = sum(p.numel() for p in got.params)
    nbytes = group_bytes(got)
    res = {"groups": len(got.keys), "leaves": len(got.params), "elements": n,
           "adam_bf16_fused": {
               "err": err, "launches": launches["adam_bf16_fused"], "chunks": len(got.chunks),
               "ms": staged_device_ms(run, got.staging),
               "call_ms": time_ms(run, iters=10, warmup=2),
               "host_ms": sorted(host)[len(host) // 2], "host_ms_all": host,
               "plain_ms": time_ms(lambda: adam_bf16_fused.adam_bf16_fused_apply_reference(
                   want, flat_grads, steps, **kw), iters=1, warmup=0),
               "bytes": nbytes, "bound": list(bound(nbytes, (ADAM_OPS + EPILOGUE_OPS) * n))}}
    # nearest library call, not the same function: torch's fused AdamW over
    # the same fp32 lists (with fp32 copies of the gradients: it takes
    # gradients of the params' dtype) at one lr
    ps, ms, vs = want.params, want.mu, want.nu
    gs = [g.float() for g in flat_grads]
    counts = [torch.tensor(3.0, device=ps[0].device) for _ in ps]
    res["adam_bf16_fused"]["library_ms"] = time_ms(lambda: torch._fused_adamw_(
        ps, gs, ms, vs, [], counts, lr=5e-4, beta1=b1, beta2=b2, weight_decay=2e-2, eps=eps,
        amsgrad=False, maximize=False))
    res["adam_bf16_fused"]["library"] = (
        "torch._fused_adamw_ over the same fp32 lists, fp32 gradients, one lr (nearest call, "
        "not the same function)")
    del want, gs, plain_masters, plain_state, state
    return res, masters


def lora_kernel_case(gen: torch.Generator) -> dict:
    """The optimizer and EMA kernels in the form the lora phase runs them,
    over lora.yaml's 264 groups of two LoRA factors each (SD1.5 width):
    ``lora_adam_case``, then ema_fused as the trainer's EMA launches it over
    the updated masters: one launch over all 384 UNet factors, with fp32 and
    with bf16 shadows, bit for bit against its plain version; its device
    time by CUDA events with the launches queued behind a spin kernel
    (``device_ms``), beside torch._foreach_lerp_."""
    groups = lora_groups()
    res, masters = lora_adam_case(gen, groups, load_with_defaults(CONFIGS_DIR / "lora.yaml"))
    keys = sorted(k for comp, ks, _, _ in groups if comp == "unet" for k in ks)
    ps = [masters[k] for k in keys]
    one_minus, step = one_minus_decay(EMA_DECAY, 9), 8
    res["ema_fused"] = {}
    for name, s_dtype in EMA_DTYPES.items():
        shadows = [(p + rand(p.shape, gen, 1e-3, torch.float32)).to(s_dtype) for p in ps]
        e_got = ema_fused.build_ema_table(keys, clones(shadows), ps)
        e_want = ema_fused.build_ema_table(keys, clones(shadows), ps)
        torch.cuda.synchronize()
        reset_launches()
        ema_fused.ema_fused_apply(e_got, one_minus, step)
        launches = read_launches()
        ema_fused.ema_fused_apply_reference(e_want, one_minus, step)
        torch.cuda.synchronize()
        pairs = list(zip(e_got.shadows, e_want.shadows, shadows))
        equal = all(torch.equal(a, b) for a, b, _ in pairs)
        e_err = max(max_abs(a, b) for a, b, _ in pairs)
        check(equal, f"ema_fused over the LoRA factors ({name} shadows of fp32 masters) "
                     f"disagrees with its plain version: {e_err}")
        moved = sum(not torch.equal(a, s0) for a, _, s0 in pairs)
        check(moved == len(pairs), f"ema_fused moved {moved} of {len(pairs)} LoRA shadows")
        e_n = sum(sh.numel() for sh in e_got.shadows)
        e_bytes = ema_bytes(e_got)
        s32 = [rand(p.shape, gen, 2e-2, torch.float32) for p in ps]

        def run(t=e_got):
            ema_fused.ema_fused_apply(t, one_minus, step)

        res["ema_fused"][name] = {
            "shadow": str(s_dtype), "groups": sum(comp == "unet" for comp, *_ in groups),
            "leaves": len(keys), "elements": e_n, "launches": launches["ema_fused"],
            "bit_equal": equal, "max_abs_err": e_err,
            "ms": device_ms(run, iters=10, warmup=2),
            "call_ms": time_ms(run, iters=10, warmup=2),
            "plain_ms": time_ms(lambda: ema_fused.ema_fused_apply_reference(e_want, one_minus,
                                                                            step),
                                iters=1, warmup=0),
            "bytes": e_bytes, "bound": list(bound(e_bytes, EMA_OPS * e_n)),
            # the same function for an fp32 shadow of fp32 masters
            "library_ms": device_ms(lambda: torch._foreach_lerp_(s32, ps, one_minus),
                                    iters=10, warmup=2)}
        check(launches["ema_fused"] == 1, f"the LoRA EMA launched {launches}")
    return res


# -- sampling: the sample CLI, in-training sampling, DreamBooth class images ----------

SAMPLE_METHODS = ("ddim", "euler", "euler_a", "dpmpp_2m")
SAMPLING_SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 5632, 40), (2, 8, 1408, 80)]
# final latents after the 28-step DDIM ladder, kernel path against the plain
# attention path: relative L2 error, ||a - b|| / ||b|| (the bound stated before
# the first run)
SAMPLE_FINAL_TOL = 0.25
ARB_SAMPLE_SIZE = (704, 512)              # (w, h): 88x64 latents, L = 5632 and 1408
LORA_SAMPLE_EVERY, LORA_SAMPLES = 4, 2   # the lora phase's cut of lora.yaml's sampling
DB_CLASS_IMAGES, DB_STEPS = 4, 4         # the dreambooth phase's cuts of dreambooth.yaml
HOLD_CYCLES = 2_000_000_000             # ~1 s spin: a whole UNet call queues behind it


class SampleProbe:
    """What sampling runs do, read at the sampler module's functions while
    the probe is open: for each ``sample_images`` call its host seconds (the
    images come back to the host, so the device is done), its UNet calls,
    and whether the latents the decoder took and its images were finite."""

    def __init__(self):
        self.calls: list[dict] = []

    def __enter__(self):
        self._real = (sampler.sample_images, sampler.unet_apply, sampler.decoder_apply)
        images_fn, unet_fn, decoder_fn = self._real
        probe, state = self, {}

        def _sample_images(*args, **kwargs):
            state.update(unet_calls=0, finite=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = images_fn(*args, **kwargs)
            probe.calls.append({"s": time.perf_counter() - t0, "images": len(out), **state})
            return out

        def _unet(*args, **kwargs):
            state["unet_calls"] += 1
            return unet_fn(*args, **kwargs)

        def _decoder(params, latents, config):
            out = decoder_fn(params, latents, config)
            state["finite"] &= bool(torch.isfinite(latents).all() and torch.isfinite(out).all())
            return out

        sampler.sample_images, sampler.unet_apply, sampler.decoder_apply = (
            _sample_images, _unet, _decoder)
        return self

    def __exit__(self, *exc):
        sampler.sample_images, sampler.unet_apply, sampler.decoder_apply = self._real


def shipped_concept():
    """configs/dreambooth.yaml's sampling concept (the prompt, negative
    prompt, 28 steps, cfg 11, 512^2, seed 114514 of every shipped SD1.x
    config), and its clip_stop_at_layer."""
    cfg = load_with_defaults(CONFIGS_DIR / "dreambooth.yaml")
    return cfg.sampling.concepts[0], int(cfg.clip_stop_at_layer)


def png_pixels(path: Path, size: tuple[int, int]) -> np.ndarray:
    """The pixels of a PNG the sampler wrote, checked to be a (w, h) RGB image."""
    from PIL import Image

    with Image.open(path) as img:
        check(img.format == "PNG" and img.mode == "RGB" and img.size == size,
              f"{path}: {img.format} {img.mode} {img.size}, expected an RGB PNG of {size}")
        return np.asarray(img)


def sampling_kernel_case(shape, gen: torch.Generator, rate: tuple[int, float]) -> dict:
    """splash_fwd in sampling's form (inference mode, the CFG pair's batch,
    head-split views) against its plain version, at FWD_TOL and LSE_TOL, and
    a second launch equal bit for bit; its time, its plain version's and
    SDPA's forward, each queued behind a spin kernel, beside the bound."""
    b, h, l, d = shape
    q, k, v = (head_views(shape, gen) for _ in range(3))
    with torch.inference_mode():
        qs = splash._prescale(q, d ** -0.5)
        o, lse = splash.splash_fwd(qs, k, v)
        o2, lse2 = splash.splash_fwd(qs, k, v)
        o_ref, lse_ref = splash.splash_fwd_reference(qs, k, v)
        err, lse_err = max_abs(o, o_ref), max_abs(lse, lse_ref)
        same_bits = torch.equal(o, o2) and torch.equal(lse, lse2)
        check(err <= FWD_TOL, f"splash_fwd (inference) disagrees at {shape}: {err}")
        check(lse_err <= LSE_TOL, f"splash_fwd (inference) lse disagrees at {shape}: {lse_err}")
        check(same_bits, f"splash_fwd (inference) gives other bits on a second launch at {shape}")
        res = {"shape": list(shape), "err": err, "lse_err": lse_err, "same_bits": same_bits,
               "ms": device_ms(lambda: splash.splash_fwd(qs, k, v)),
               "plain_ms": device_ms(lambda: splash.splash_fwd_reference(qs, k, v), iters=3),
               "sdpa_fwd_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)),
               "bound": list(bounds_ms(b, h, l, l, d, *rate)["splash_fwd"])}
        res["fwd_over_sdpa"] = res["ms"] / res["sdpa_fwd_ms"]
    del q, k, v, qs, o, lse, o2, lse2, o_ref, lse_ref
    torch.cuda.empty_cache()
    return res


def device_ops(fn) -> tuple[int, float]:
    """(CUDA operations, their summed device ms) of one call of fn(), from a
    torch.profiler trace after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(events), sum(e.time_range.elapsed_us() for e in events) / 1e3


def sampling_check(model: Path, seed: int, concept, clip_skip: int = 1) -> dict:
    """On the model directory's components in bf16: the DDIM loop at
    ``concept``'s settings with the kernels, then with the attention gate
    closed (ops/attention.FORCE_MATH), from one initial noise. The latents
    after the first step (the second UNet call's input) within CHECK_TOL of
    each other (relative max-abs, as the check phase), the final latents
    within SAMPLE_FINAL_TOL (relative L2), both finite; splash_fwd launches
    as the gate admits per UNet call with the kernels, none without. Then
    the device ms of one UNet call on the CFG pair (and its host ms, issuing
    included), of the VAE decode of one image and of the text encoder(s) on
    the pair, and the CUDA operations of one UNet call. An SDXL directory
    conditions through both towers and the CFG pair's added_cond."""
    models = load_components(merge(default(), Config({"model": str(model)})))
    spec = sampler.SamplerSpec(unet_config=models.unet_config, vae_config=models.vae_config,
                               clip_config=models.clip_config, schedule=models.schedule,
                               clip_stop_at_layer=clip_skip, clip2_config=models.clip2_config)
    unet, vae, clip = (sampler.cast_params(p, spec.dtype, DEVICE)
                       for p in (models.unet, models.vae, models.clip))
    clip2 = sampler.cast_params(models.clip2, spec.dtype, DEVICE) if spec.sdxl else None
    del models
    tokenizer = CLIPBPETokenizer.from_dir(model / "tokenizer")
    steps, cfg_scale = int(concept.steps), float(concept.cfg_scale)
    width, height = int(concept.width), int(concept.height)
    f = 2 ** (len(spec.vae_config.block_out_channels) - 1)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    res: dict = {}
    with torch.inference_mode():
        ids = torch.from_numpy(np.asarray(tokenizer([concept.negative_prompt, concept.prompt]),
                                          np.int64)).to(DEVICE)
        added = None
        if spec.sdxl:
            encode = lambda: encode_sdxl(clip, clip2, ids, spec.clip_config,  # noqa: E731
                                         spec.clip2_config)
            context, pooled = encode()
            added = {"text_embeds": pooled.to(spec.dtype),
                     "time_ids": torch.tensor([height, width, 0, 0, height, width],
                                              dtype=torch.float32, device=DEVICE).expand(2, 6)}
        else:
            encode = lambda: clip_text_apply(clip, ids, spec.clip_config,  # noqa: E731
                                             clip_skip)
            context = encode()
        uncond, cond = context[:1], context[1:]
        noise = torch.randn(1, spec.unet_config.in_channels, height // f, width // f,
                            generator=gen, dtype=torch.bfloat16, device=DEVICE)

        def ddim(force_math: bool):
            inputs, real = [], sampler.unet_apply

            def record(p, x, t, c, config, **kw):
                inputs.append(x[:1].clone())
                return real(p, x, t, c, config, **kw)

            sampler.unet_apply, attention.FORCE_MATH = record, force_math
            reset_launches()
            try:
                out = sampler.ddim_sample_latents(unet, cond, uncond, None, spec, steps,
                                                  cfg_scale, height, width, 1,
                                                  draws=sampler.SamplerDraws(noise=noise),
                                                  added_cond=added)
            finally:
                sampler.unet_apply, attention.FORCE_MATH = real, False
            torch.cuda.synchronize()
            return inputs[1], out, read_launches()["splash_fwd"]

        k_first, k_final, k_launches = ddim(False)
        p_first, p_final, p_launches = ddim(True)
        check(all(bool(torch.isfinite(t).all()) for t in (k_first, k_final, p_first, p_final)),
              "non-finite DDIM latents")
        calls = splash_calls((2, height, width, 3), spec.unet_config)
        check(k_launches == steps * calls and p_launches == 0,
              f"splash_fwd launches {k_launches} (kernels), {p_launches} (plain)")
        res["first_step_rel_err"] = rel_err(k_first, p_first)
        res["final_rel_err"] = float((k_final.float() - p_final.float()).norm()
                                     / p_final.float().norm())
        res["final_rel_max_abs_err"] = rel_err(k_final, p_final)
        check(res["first_step_rel_err"] <= CHECK_TOL,
              f"first DDIM step, kernel path vs plain: {res['first_step_rel_err']}")
        check(res["final_rel_err"] <= SAMPLE_FINAL_TOL,
              f"final DDIM latents after {steps} steps, kernel path vs plain: "
              f"{res['final_rel_err']}")

        pair = torch.cat([noise, noise])
        t = torch.full((2,), 500, device=DEVICE)
        call = lambda: unet_apply(unet, pair, t, context, spec.unet_config,  # noqa: E731
                                  added_cond=added)
        # 3 calls: the host of an H100 machine took 70-180 ms to issue one
        # SDXL call, and all of them must queue behind the ~1 s spin for the
        # host's time not to count
        res["unet_device_ms"] = device_ms(call, iters=3, warmup=1, hold_cycles=HOLD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        res["unet_host_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        res["unet_ops"], res["unet_ops_device_ms"] = device_ops(call)
        z = noise.float().div(spec.vae_config.scaling_factor).bfloat16()
        res["vae_decode_ms"] = device_ms(lambda: decoder_apply(vae, z, spec.vae_config), iters=5,
                                         warmup=1, hold_cycles=HOLD_CYCLES)
        res["clip_ms"] = device_ms(encode, iters=10, hold_cycles=HOLD_CYCLES)
    del unet, vae, clip, clip2
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sample_phase(seed: int, workdir: Path, model: Path, images: Path) -> dict:
    """The sample CLI on the trainer phase's SD1.5 directory at the shipped
    concept's settings: a warm-up image, then one image with each method,
    one with guidance rescale 0.7, one img2img (strength 0.75 from one of
    the uncached phase's PNGs), one at 704x512, and the first DDIM image
    again. Each run's launches are counted alone: splash_fwd 10 per UNet
    call where the gate admits the lengths (at 704x512 as well: L = 5632 and
    1408), no backward or optimizer kernel. The PNGs are valid, decoded from
    finite latents, and the repeat's bytes equal the first's. Then
    ``sampling_check``."""
    concept, clip_skip = shipped_concept()
    steps = int(concept.steps)
    base = ["--model", str(model), "--prompt", concept.prompt, "--negative",
            concept.negative_prompt, "--steps", str(steps), "--cfg", str(concept.cfg_scale),
            "--seed", str(concept.seed), "--clip-skip", str(clip_skip), "--device", DEVICE]
    # one image per method (a second one was cut to keep the smoke inside its
    # time limit; "repeat" gives a second DDIM time)
    runs = {"warmup": ("ddim", []), **{m: (m, []) for m in SAMPLE_METHODS},
            "rescale": ("ddim", ["--guidance-rescale", "0.7"]),
            "img2img": ("ddim", ["--init-image", str(images / "img_000.png"),
                                 "--strength", "0.75"]),
            "704x512": ("ddim", []),
            "repeat": ("ddim", [])}
    unet_config = UNetConfig.sd15()
    res: dict = {"runs": {}}
    launches_total = dict.fromkeys(read_launches(), 0)
    peak = 0.0
    for name, (method, extra) in runs.items():
        out = workdir / "samples" / name
        width, height = (ARB_SAMPLE_SIZE if name == "704x512"
                         else (int(concept.width), int(concept.height)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SampleProbe() as probe:
            sample_cli.main(base + ["--method", method, "--width", str(width), "--height",
                                    str(height), "--out", str(out)] + extra,
                            standalone_mode=False)
        launches = read_launches()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        for k, v in launches.items():
            launches_total[k] += v
        images = len(probe.calls)
        check(images == (2 if "--num" in extra else 1) and all(c["finite"] for c in probe.calls)
              and all(c["images"] == 1 for c in probe.calls), f"sample {name}: {probe.calls}")
        pngs = sorted(out.glob("*.png"))
        check(len(pngs) == images, f"sample {name} wrote {pngs}")
        pixels = [png_pixels(p, (width, height)) for p in pngs]
        steps_run = steps - int(steps * 0.25) if name == "img2img" else steps
        calls = splash_calls((2, height, width, 3), unet_config)
        check(all(c["unet_calls"] == steps_run for c in probe.calls)
              and launches["splash_fwd"] == images * steps_run * calls
              and sum(launches.values()) == launches["splash_fwd"],
              f"sample {name}: UNet calls {[c['unet_calls'] for c in probe.calls]}, launches "
              f"{launches}, expected {steps_run} calls per image and splash_fwd {calls} per "
              "call only")
        secs = [c["s"] for c in probe.calls]
        res["runs"][name] = {
            "method": method, "size": [width, height], "s_per_image": secs,
            "unet_calls": steps_run, "unet_calls_per_s": [steps_run / t for t in secs],
            "launches": launches, "splash_fwd_per_image": launches["splash_fwd"] // images,
            "png_sha256": hashlib.sha256(pngs[0].read_bytes()).hexdigest(),
            "pixel_mean": float(pixels[0].mean())}
    first, again = res["runs"]["ddim"], res["runs"]["repeat"]
    check(first["png_sha256"] == again["png_sha256"],
          "the same seed twice gave other PNG bytes")
    res["deterministic"] = True
    res["peak_mem_gib"] = peak
    res["launches"] = launches_total
    res["check"] = sampling_check(model, seed, concept, clip_skip)
    return res


class CallbackProbe:
    """The seconds of each SampleCallback call that wrote samples."""

    def __init__(self):
        self.events: list[tuple[int, float]] = []

    def __enter__(self):
        self._real = SampleCallback.__call__
        real, probe = self._real, self

        def _call(cb, trainer, step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real(cb, trainer, step)
            torch.cuda.synchronize()
            if (cb.sample_dir / str(step)).is_dir():
                probe.events.append((step, time.perf_counter() - t0))

        SampleCallback.__call__ = _call
        return self

    def __exit__(self, *exc):
        SampleCallback.__call__ = self._real


def dreambooth_phase(seed: int, workdir: Path, model: Path, images: Path) -> dict:
    """The port's configs/dreambooth.yaml on the trainer phase's SD1.5
    directory, with the uncached phase's PNGs as the instance set. Cut:
    num_target DB_CLASS_IMAGES, the run DB_STEPS steps (max_epochs 100 in the
    file), the dataset. The class-image CLI makes DB_CLASS_IMAGES images at
    512^2 (28 DDIM steps, cfg 11, one per batch), MD5-named PNGs; run again,
    it makes none. Then the train CLI trains DB_STEPS steps with prior
    preservation (batch 2 instance + 2 class images), the full UNet with
    remat: splash fwd 20, dq 10, dkv 10 and adam_bf16_fused one per step."""
    base = load_with_defaults(CONFIGS_DIR / "dreambooth.yaml")
    c0 = base.data.concepts[0]
    class_dir = workdir / "class"
    concept = {"instance_set": {"path": str(images), "prompt": c0.instance_set.prompt},
               "class_set": {"path": str(class_dir), "prompt": c0.class_set.prompt,
                             "auto_generate": {**c0.class_set.auto_generate,
                                               "num_target": DB_CLASS_IMAGES}}}
    config = merge(base, Config({
        "model": str(model), "output_dir": str(workdir / "db_runs"), "project": "dreambooth",
        "seed": seed, "num_workers": NUM_WORKERS, "data": {"concepts": [concept]},
        "trainer": {"max_steps": DB_STEPS, "log_every_n_steps": 1},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None, "monitor": None},
        "loggers": {"tensorboard": None}}))
    check(config.prior_preservation.enabled and config.batch_size == 2
          and not config.aspect_ratio_bucket.enabled and config.gradient_checkpointing is True
          and c0.class_set.auto_generate.steps == 28, "dreambooth.yaml changed")
    cfg_path = workdir / "dreambooth.yaml"
    cfg_path.write_text(json.dumps(config))
    res: dict = {"class_images": DB_CLASS_IMAGES, "steps": DB_STEPS}

    runs = []
    for _ in range(2):
        reset_launches()
        with SampleProbe() as probe:
            gen_class_imgs_cli.main(["--config", str(cfg_path), "--device", DEVICE],
                                    standalone_mode=False)
        runs.append((probe.calls, read_launches(), sorted(class_dir.glob("*.png"))))
    (calls1, launches1, made), (calls2, launches2, again) = runs
    check(len(made) == DB_CLASS_IMAGES and len(calls1) == DB_CLASS_IMAGES
          and all(c["finite"] for c in calls1), f"class images: {made}, calls {calls1}")
    for p in made:
        pixels = png_pixels(p, (int(config.data.resolution),) * 2)
        check(p.stem == hashlib.md5(pixels.tobytes()).hexdigest(), f"{p.name} is not its MD5")
    steps, res_px = int(c0.class_set.auto_generate.steps), int(config.data.resolution)
    unet_config = UNetConfig.sd15()
    check(launches1["splash_fwd"]
          == DB_CLASS_IMAGES * steps * splash_calls((2, res_px, res_px, 3), unet_config)
          and sum(launches1.values()) == launches1["splash_fwd"], f"class launches {launches1}")
    check(again == made and not calls2 and not any(launches2.values()),
          f"the second class-image run made {len(again) - len(made)} images, "
          f"launches {launches2}")
    res["class_s_per_image"] = [c["s"] for c in calls1]

    calls = splash_calls((4, res_px, res_px, 3), unet_config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as run:
        train_cli.main(["--config", str(cfg_path), "--run-id", "db", "--device", DEVICE],
                       standalone_mode=False)
    launches = read_launches()
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    losses = run.losses()
    check(sorted(losses) == list(range(1, DB_STEPS + 1))
          and all(math.isfinite(x) for x in losses.values()), f"dreambooth losses {losses}")
    want = {"splash_fwd": 2 * calls * DB_STEPS, "splash_dq": calls * DB_STEPS,
            "splash_dkv": calls * DB_STEPS, "adam_bf16_fused": ADAM_PER_STEP * DB_STEPS,
            "adam8_fused": 0, "ema_fused": 0}
    check(launches == want, f"dreambooth launches {launches}, expected {want}")
    for p in (workdir / "db_runs").rglob("*.safetensors*"):
        p.unlink()
    dts = [1.0 / m["steps_per_sec"] for s, m, _ in run.steps if s != 1]
    res.update({"losses": [losses[s] for s in sorted(losses)],
                "steps_per_s": len(dts) / sum(dts), "train_launches": launches,
                "launches": {k: launches1[k] + launches[k] for k in launches}})
    return res


# -- SDXL: configs/sdxl_lora.yaml at SDXL-base's published widths ----------------------

SDXL_VAE_SCALE = 0.13025   # SDXL-base's vae/config.json scaling_factor
SDXL_RESOLUTION = 1024     # sdxl_lora.yaml's data.resolution and sampling size
# (w, h) of the SDXL phases' PNGs, two each: ARB at 1024 puts them in the
# 1024x1024, 1408x1024 and 1024x1408 buckets (L = 4096 / 1024 and 5632 / 1408)
SDXL_IMAGE_SIZES = [(1024, 1024), (1152, 896), (896, 1152)]
SDXL_IMAGES = 6            # one epoch of 6 steps at sdxl_lora.yaml's batch 1
SDXL_STEPS, SDXL_SAVE_EVERY = 6, 4       # the lora run and its mid-epoch checkpoint
SDXL_SAMPLE_EVERY, SDXL_SAMPLES = 4, 2   # the cut of sdxl_lora.yaml's sampling (100 x 4)
SDXL_CACHED_STEPS = 2
# splash in SDXL's training forms (batch 1, head dim 64): 1024^2 levels 1
# and 2, and a ragged ARB length (72 x 56); the lora run's bucket shapes join
# them. Sampling's: the CFG pair at 1024^2.
SDXL_KERNEL_SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64), (1, 10, 4032, 64)]
SDXL_SAMPLING_SHAPES = [(2, 10, 4096, 64), (2, 20, 1024, 64)]


def write_sdxl_images(root: Path, seed: int) -> Path:
    """SDXL_IMAGES PNGs of random pixels at SDXL_IMAGE_SIZES, with captions."""
    from PIL import Image

    d = root / "sdxl_images"
    d.mkdir(parents=True)
    r = np.random.RandomState(seed + 30)
    for i in range(SDXL_IMAGES):
        w, h = SDXL_IMAGE_SIZES[i % len(SDXL_IMAGE_SIZES)]
        Image.fromarray(r.randint(0, 256, (h, w, 3), np.uint8)).save(d / f"img_{i:03d}.png")
        (d / f"img_{i:03d}.txt").write_text(f"a photo of the dog number {i}, tag {i % 3}")
    return d


def write_sdxl_dir(root: Path, seed: int) -> Path:
    """A diffusers directory of SDXL-base at its published widths in bf16,
    random weights from ``seed``: the text_time UNet (UNetConfig.sdxl, 2.57 B
    parameters), the VAE (SD's, scaling factor 0.13025), CLIP ViT-L and
    OpenCLIP bigG with its text_projection (both towers' EOS id the
    synthetic vocab's), the scheduler (scaled_linear 0.00085-0.012,
    steps_offset 1) and the synthetic vocab."""
    d = root / "sdxl"
    tok = write_vocab(d / "tokenizer")
    eos = {"eos_token_id": len(json.loads((tok / "vocab.json").read_text())) - 1}
    parts = {"unet": (UNetConfig.sdxl(), init_unet_params),
             "vae": (dataclasses.replace(VAEConfig.sd15(), scaling_factor=SDXL_VAE_SCALE),
                     init_vae_params),
             "text_encoder": (dataclasses.replace(CLIPTextConfig.vit_l(), **eos),
                              init_clip_params),
             "text_encoder_2": (dataclasses.replace(CLIPTextConfig.sdxl_g(), **eos),
                                init_clip_params)}
    for i, (name, (cfg, init)) in enumerate(parts.items()):
        params = init(cfg, seed=seed + 20 + i, device=DEVICE, dtype=torch.bfloat16)
        (d / name).mkdir()
        save_state_dict(params, d / name / "diffusion_pytorch_model.safetensors")
        (d / name / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        del params
    torch.cuda.empty_cache()
    (d / "scheduler").mkdir()
    (d / "scheduler" / "scheduler_config.json").write_text(json.dumps(SD15_SCHEDULER))
    return d


def sdxl_config(workdir: Path, name: str, model: Path, images: Path, seed: int,
                overrides: dict) -> tuple[Config, Path]:
    """The port's configs/sdxl_lora.yaml on ``model`` and ``images`` with
    ``overrides``, written to ``workdir/<name>.yaml``."""
    base = load_with_defaults(CONFIGS_DIR / "sdxl_lora.yaml")
    check(base.gradient_checkpointing is True and base.aspect_ratio_bucket.enabled
          and base.batch_size == 1 and base.optim_target == "lora_sdxl"
          and base.data.resolution == SDXL_RESOLUTION and base.sampling.method == "dpmpp_2m",
          "sdxl_lora.yaml changed")
    config = merge(base, Config({
        "model": str(model), "output_dir": str(workdir / "sdxl_runs"), "project": name,
        "seed": seed, "num_workers": NUM_WORKERS,
        "data": {"concepts": [{"instance_set": {"path": str(images),
                                                "prompt": "{TXT_PROMPT}"}}]},
        "loggers": {"tensorboard": None}}), Config(overrides))
    path = workdir / f"{name}.yaml"
    path.write_text(json.dumps(config))
    return config, path


def sdxl_bases() -> dict[str, dict]:
    """SDXL-base's param shapes by component."""
    return {"unet": unet_param_shapes(UNetConfig.sdxl()),
            "text_encoder": clip_param_shapes(CLIPTextConfig.vit_l()),
            "text_encoder_2": clip_param_shapes(CLIPTextConfig.sdxl_g())}


def sdxl_groups() -> dict[str, int]:
    """lora_sdxl's param groups per component at SDXL-base's widths."""
    groups = lora_groups("lora_sdxl", sdxl_bases())
    return {comp: sum(g[0] == comp for g in groups) for comp in sdxl_bases()}


KERNEL_CATEGORIES = (   # kernel name fragment -> category, first match wins
    ("splash_", "splash"), ("adam", "optimizer"), ("conv", "convs"), ("fprop", "convs"),
    ("dgrad", "convs"), ("wgrad", "convs"), ("cudnn", "convs"), ("gemm", "GEMMs"),
    ("cutlass", "GEMMs"), ("nvjet", "GEMMs"), ("xmma", "GEMMs"),
    ("norm", "norms"), ("reduce", "reductions"), ("softmax", "softmax"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"), ("unrolled", "elementwise"),
    ("copy", "elementwise"), ("cat", "elementwise"))


def trace_breakdown(path: Path) -> dict:
    """One traced step from a torch.profiler Chrome trace: its kernels'
    count and summed device ms by category, the device's busy ms (the union
    of the kernels' intervals) over the traced span (first to last kernel
    or runtime call), and the host's kernel launches."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    check(bool(kernels), f"{path}: the profiled step traced no kernel")
    launches = sum(e.get("cat") == "cuda_runtime" and "LaunchKernel" in e.get("name", "")
                   for e in events)
    by: dict[str, float] = {}
    for e in kernels:
        name = e["name"].lower()
        cat = next((c for frag, c in KERNEL_CATEGORIES if frag in name), "other")
        by[cat] = by.get(cat, 0.0) + e["dur"] / 1e3
    busy, end = 0.0, -math.inf
    for e in sorted(kernels, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    timed = kernels + [e for e in events if e.get("cat") == "cuda_runtime" and "dur" in e]
    span = (max(e["ts"] + e["dur"] for e in timed) - min(e["ts"] for e in timed)) / 1e3
    return {"kernels": len(kernels), "kernel_ms": sum(by.values()), "busy_ms": busy / 1e3,
            "span_ms": span, "busy_share": busy / 1e3 / span, "launches": launches,
            "by_category_ms": dict(sorted(by.items(), key=lambda kv: -kv[1]))}


def sdxl_cache_phase(seed: int, workdir: Path, model: Path, images: Path) -> dict:
    """The cache CLI on the SDXL directory over the SDXL PNGs at 1024 ARB
    (batch 1): every entry holds {id}.latent.0, {id}.cond (77, 2048: both
    towers' penultimate states) and {id}.pooled (1280,); then the train CLI
    trains SDXL_CACHED_STEPS lora_sdxl steps from the file."""
    cache = workdir / "sdxl_cache.safetensors"
    timings = workdir / "sdxl_cache_timings.jsonl"
    _, cfg_path = sdxl_config(workdir, "sdxl_cache", model, images, seed, {
        "data": {"cache": str(cache)}, "sampling": {"concepts": []},
        "trainer": {"max_steps": SDXL_CACHED_STEPS, "log_every_n_steps": 1},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None,
                       "every_n_train_steps": None, "monitor": None}})
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cache_cli.main(["--config", str(cfg_path), "--batch-size", "1", "--device", DEVICE],
                   standalone_mode=False)
    encode_s = time.perf_counter() - t0
    encode_launches = read_launches()
    check(not any(encode_launches.values()), f"the cache encode launched {encode_launches}")
    c = LatentCache(cache)
    entries = [int(i) for i in c.entries]
    width = UNetConfig.sdxl().cross_attention_dim            # both towers' states
    pooled = CLIPTextConfig.sdxl_g().projection_dim
    check(len(entries) == SDXL_IMAGES and all(
        c.cond(i).shape == (77, width) and c.pooled(i).shape == (pooled,)
        and np.isfinite(c.pooled(i)).all() for i in entries),
        f"the SDXL cache: {len(entries)} entries, keys {sorted(c._keys)[:6]}")
    os.environ["SSDT_STEP_TIMINGS"] = str(timings)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with TrainerProbe() as run:
            train_cli.main(["--config", str(cfg_path), "--run-id", "cached", "--device", DEVICE],
                           standalone_mode=False)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        os.environ.pop("SSDT_STEP_TIMINGS", None)
    gc.collect()
    torch.cuda.empty_cache()
    losses = run.losses()
    check(sorted(losses) == list(range(1, SDXL_CACHED_STEPS + 1))
          and all(math.isfinite(x) for x in losses.values()), f"cached SDXL losses {losses}")
    shapes = step_shapes(timings)
    expect_train_splash(shapes, launches, "cached SDXL steps", UNetConfig.sdxl(), vae_factor=1)
    check(launches["adam_bf16_fused"] == ADAM_PER_STEP * SDXL_CACHED_STEPS
          and launches["adam8_fused"] == launches["ema_fused"] == 0,
          f"cached SDXL launches {launches}")
    return {"entries": len(entries), "encode_s": encode_s,
            "images_per_s": len(entries) / encode_s, "file_mib": cache.stat().st_size / 2 ** 20,
            "latent_shapes": sorted({tuple(s) for s in shapes}),
            "losses": [losses[s] for s in sorted(losses)], "peak_mem_gib": peak,
            "launches": launches, "first_step_s": run.steps[0][2]}


def sdxl_lora_phase(seed: int, workdir: Path, model: Path, images: Path) -> dict:
    """The port's configs/sdxl_lora.yaml through the train CLI on the SDXL
    directory: LoRA on the UNet and both towers (rank 16), remat, ARB at
    1024, batch 1, uncached. Run 1 trains SDXL_STEPS steps with a
    checkpoint at SDXL_SAVE_EVERY (mid-epoch) and one sampling event of
    SDXL_SAMPLES images (24 DPM++(2M) steps, cfg 7, 1024^2) just before it;
    run 2 resumes from that checkpoint and must end on run 1's final
    checkpoint and sidecar bytes and losses. Splash launches per step match
    the gate at each step's bucket (forward twice under remat; the sampled
    images' forwards on top), adam_bf16_fused one launch per step over every
    LoRA module's group."""
    runs, timings = workdir / "sdxl_runs", workdir / "sdxl_timings.jsonl"
    base = load_with_defaults(CONFIGS_DIR / "sdxl_lora.yaml")
    concepts = [{**c, "num_samples": SDXL_SAMPLES} for c in base.sampling.concepts]
    config, cfg_path = sdxl_config(workdir, "sdxl_lora", model, images, seed, {
        "sampling": {"interval_steps": SDXL_SAMPLE_EVERY, "concepts": concepts},
        "trainer": {"max_steps": SDXL_STEPS, "log_every_n_steps": 1},
        # a torch.profiler trace of the step after the checkpoint (left out
        # of the rate, as the write precedes it)
        "profiler": {"enabled": True, "start_step": SDXL_SAVE_EVERY, "num_steps": 1},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None,
                       "every_n_train_steps": SDXL_SAVE_EVERY, "monitor": None}})
    groups = sdxl_groups()
    n_groups = sum(groups.values())
    concept = concepts[0]
    size = (int(concept["width"]), int(concept["height"]))
    sample_steps = int(concept["steps"])
    os.environ["SSDT_STEP_TIMINGS"] = str(timings)

    def cli(args, probe):
        with probe:
            train_cli.main(args + ["--device", DEVICE], standalone_mode=False)
        gc.collect()
        torch.cuda.empty_cache()

    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run1 = TrainerProbe()
        with CallbackProbe() as sampling:
            cli(["--config", str(cfg_path), "--run-id", "run1"], run1)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        shapes1 = step_shapes(timings)
        check([s for s, _, _ in run1.steps] == list(range(1, SDXL_STEPS + 1))
              and all(math.isfinite(x) for x in run1.losses().values()),
              f"SDXL lora run 1: steps {[s for s, _, _ in run1.steps]}, losses {run1.losses()}")
        check(len({tuple(s) for s in shapes1}) > 1, f"ARB buckets {shapes1}")
        sample_dir = runs / "sdxl_lora" / "run1" / "samples"
        events = SDXL_STEPS // SDXL_SAMPLE_EVERY
        check([step for step, _ in sampling.events] ==
              [SDXL_SAMPLE_EVERY * (i + 1) for i in range(events)],
              f"SDXL lora run 1 sampled at {sampling.events}")
        for step, _ in sampling.events:
            pngs = sorted((sample_dir / str(step)).glob("*.png"))
            check([p.name for p in pngs] == [f"0-{j}.png" for j in range(SDXL_SAMPLES)],
                  f"SDXL lora run 1 samples at step {step}: {pngs}")
            for p in pngs:
                png_pixels(p, size)
        per_image = sample_steps * splash_calls((2, size[1], size[0], 3), UNetConfig.sdxl())
        sampled = events * SDXL_SAMPLES * per_image
        calls = expect_train_splash(shapes1, launches, "SDXL lora run 1", UNetConfig.sdxl(),
                                    sampled=sampled)
        check(launches["adam_bf16_fused"] == ADAM_PER_STEP * SDXL_STEPS
              and launches["ema_fused"] == launches["adam8_fused"] == 0,
              f"SDXL lora run 1 launches {launches}")
        dir1 = runs / "sdxl_lora" / "run1"
        mid, last = (f"epoch=0-step={n}" for n in (SDXL_SAVE_EVERY, SDXL_STEPS))
        check(sorted(p.name for p in dir1.glob("*.safetensors")) ==
              [mid + ".safetensors", last + ".safetensors"],
              f"SDXL lora run 1 wrote {sorted(p.name for p in dir1.iterdir())}")
        ckpt = load_state_dict(dir1 / f"{mid}.safetensors")
        factors = {k: v for k, v in ckpt.items() if k.endswith((".lora_A", ".lora_B"))}
        check(len(factors) == 2 * n_groups and len(ckpt) == 3 * n_groups
              and any(k.startswith("condition_model.encoder_2.") for k in factors),
              f"the SDXL LoRA checkpoint holds {len(ckpt)} tensors for {n_groups} modules")
        trainables = {comp: sum(v.numel() for k, v in factors.items()
                                if k.startswith(COMPONENT_PREFIX[comp] + "."))
                      for comp in groups}
        ckpt_bytes = (dir1 / f"{mid}.safetensors").stat().st_size
        sidecar_bytes = (dir1 / f"{mid}.safetensors.torchstate").stat().st_size
        want = file_digests(checkpoint_files(dir1, last))

        torch.cuda.synchronize()
        reset_launches()
        run2 = TrainerProbe()
        cli(["--resume", str(dir1 / f"{mid}.safetensors"), "--run-id", "run2"], run2)
        launches2 = read_launches()
        expect_train_splash(step_shapes(timings), launches2, "SDXL lora run 2", UNetConfig.sdxl())
        check(launches2["adam_bf16_fused"] == ADAM_PER_STEP * (SDXL_STEPS - SDXL_SAVE_EVERY),
              f"SDXL lora run 2 launches {launches2}")
        got = file_digests(checkpoint_files(runs / "sdxl_lora" / "run2", last))
        check(got == want, f"the resumed SDXL LoRA run's checkpoint differs: {got} {want}")
        l1, l2 = run1.losses(), run2.losses()
        check(sorted(l2) == list(range(SDXL_SAVE_EVERY + 1, SDXL_STEPS + 1))
              and all(l2[s] == l1[s] for s in l2), f"resumed losses {l2} != run 1's {l1}")
    finally:
        os.environ.pop("SSDT_STEP_TIMINGS", None)

    profile = trace_breakdown(dir1 / "profile" / f"trace_step{SDXL_SAVE_EVERY}.json")
    # steps over the wall time between their logs: the first step and the
    # one after the checkpoint write (and the sampling event) left out
    dts = [1.0 / m["steps_per_sec"] for s, m, _ in run1.steps if s not in (1, SDXL_SAVE_EVERY + 1)]
    dts2 = [1.0 / m["steps_per_sec"] for s, m, _ in run2.steps if s != SDXL_SAVE_EVERY + 1]
    splash_shapes = sorted({shape for b in shapes1
                            for shape, n in splash_levels(b, UNetConfig.sdxl()) if n})
    return {"steps": SDXL_STEPS, "groups": groups, "trainable_params": trainables,
            "bucket_shapes": shapes1, "splash_shapes": splash_shapes,
            "sampling": {"interval_steps": SDXL_SAMPLE_EVERY, "num_samples": SDXL_SAMPLES,
                         "steps": sample_steps, "events_s": sampling.events,
                         "splash_fwd": sampled},
            "losses": [l1[s] for s in sorted(l1)],
            "resumed_losses": [l2[s] for s in sorted(l2)], "resume_bit_equal": True,
            "steps_per_s": len(dts) / sum(dts), "resumed_steps_per_s": len(dts2) / sum(dts2),
            "step_s": dts, "first_step_s": run1.steps[0][2], "save_s": run1.saves,
            "resume_s": run2.resumes, "checkpoint_mib": ckpt_bytes / 2 ** 20,
            "sidecar_mib": sidecar_bytes / 2 ** 20, "peak_mem_gib": peak,
            "launches": {k: launches[k] + launches2[k] for k in launches},
            "launches_per_step": {k: (v - (sampled if k == "splash_fwd" else 0)) / SDXL_STEPS
                                  for k, v in launches.items()},
            "splash_calls_per_step": calls / SDXL_STEPS, "profiled_step": profile}


def sdxl_sample_phase(seed: int, workdir: Path, model: Path) -> dict:
    """The sample CLI on the SDXL directory at sdxl_lora.yaml's concept (its
    prompt and negative prompt, 24 steps, cfg 7, 1024^2, seed 114514): one
    image per method, then the concept's method (DPM++(2M)) again, whose PNG
    bytes must equal the first's. Each run: 24 UNet calls, splash_fwd 70 per
    call and no other kernel, a valid PNG decoded from finite latents. Then
    ``sampling_check`` at the concept."""
    cfg = load_with_defaults(CONFIGS_DIR / "sdxl_lora.yaml")
    concept, method = cfg.sampling.concepts[0], str(cfg.sampling.method)
    steps, size = int(concept.steps), (int(concept.width), int(concept.height))
    base = ["--model", str(model), "--prompt", concept.prompt, "--negative",
            concept.negative_prompt, "--steps", str(steps), "--cfg", str(concept.cfg_scale),
            "--seed", str(concept.seed), "--width", str(size[0]), "--height", str(size[1]),
            "--device", DEVICE]
    runs = {**{m: m for m in SAMPLE_METHODS}, "repeat": method}
    calls = splash_calls((2, size[1], size[0], 3), UNetConfig.sdxl())
    res: dict = {"runs": {}}
    launches_total = dict.fromkeys(read_launches(), 0)
    peak = 0.0
    for name, m in runs.items():
        out = workdir / "sdxl_samples" / name
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with SampleProbe() as probe:
            sample_cli.main(base + ["--method", m, "--out", str(out)], standalone_mode=False)
        launches = read_launches()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
        for k, v in launches.items():
            launches_total[k] += v
        pngs = sorted(out.glob("*.png"))
        check(len(probe.calls) == len(pngs) == 1 and probe.calls[0]["finite"]
              and probe.calls[0]["unet_calls"] == steps
              and launches["splash_fwd"] == steps * calls
              and sum(launches.values()) == launches["splash_fwd"],
              f"SDXL sample {name}: {probe.calls}, {pngs}, launches {launches}, expected "
              f"{steps} UNet calls and splash_fwd {calls} per call only")
        pixels = png_pixels(pngs[0], size)
        secs = probe.calls[0]["s"]
        res["runs"][name] = {"method": m, "size": list(size), "s_per_image": secs,
                             "unet_calls": steps, "unet_calls_per_s": steps / secs,
                             "launches": launches, "splash_fwd_per_image": launches["splash_fwd"],
                             "png_sha256": hashlib.sha256(pngs[0].read_bytes()).hexdigest(),
                             "pixel_mean": float(pixels.mean())}
    check(res["runs"][method]["png_sha256"] == res["runs"]["repeat"]["png_sha256"],
          "SDXL: the same seed twice gave other PNG bytes")
    res.update(deterministic=True, peak_mem_gib=peak, launches=launches_total)
    res["check"] = sampling_check(model, seed, concept)
    return res


def sdxl_kernel_case(gen: torch.Generator) -> dict:
    """adam_bf16_fused in the SDXL lora run's form: ``lora_adam_case`` over
    lora_sdxl's groups at SDXL-base's widths (one per LoRA module of the UNet
    and both towers) with sdxl_lora.yaml's AdamW: one launch per step."""
    res, masters = lora_adam_case(gen, lora_groups("lora_sdxl", sdxl_bases()),
                                  load_with_defaults(CONFIGS_DIR / "sdxl_lora.yaml"))
    res["groups_by_component"] = sdxl_groups()
    del masters
    torch.cuda.empty_cache()
    return res


# --- SD3 (the MMDiT) ----------------------------------------------------------------------

# splash in SD3's forms (D = 64, 24 heads): the joint attention at 1024^2
# (4096 latent + 154 text tokens) and 512^2 (1024 + 154), lengths no kernel
# tile divides (the TPU version's padded branch), and SD3.5-Medium's
# latent-only attn2 at 1024^2
SD3_KERNEL_SHAPES = [(2, 24, 4250, 64), (2, 24, 1178, 64), (2, 24, 4096, 64)]
SD3_RESOLUTION = 1024
SD3_CONTEXT = 154                 # 77 CLIP tokens, then 77 T5 tokens
SD3_BATCH, SD3_TRIPLE_BATCH = 2, 1
SD3_TRIPLE_STEPS = 3
SD3_CLI_STEPS, SD3_IMAGES, SD3_SAMPLE_STEPS = 3, 3, 28
SD3_LR = 1e-5
# stabilityai/stable-diffusion-3-medium's vae/config.json (16 latent
# channels, no quant convs) and scheduler/scheduler_config.json
SD3_VAE = dataclasses.replace(VAEConfig.sd15(), latent_channels=16, scaling_factor=1.5305,
                              shift_factor=0.0609, use_quant_conv=False,
                              use_post_quant_conv=False)
SD3_SCHEDULER = {"_class_name": "FlowMatchEulerDiscreteScheduler",
                 "num_train_timesteps": 1000, "shift": 3.0}


def sd3_towers(eos: int | None = None) -> tuple[CLIPTextConfig, CLIPTextConfig]:
    """SD3's two CLIP towers, both CLIPTextModelWithProjection: ViT-L (768)
    and OpenCLIP bigG (1280); ``eos``: their EOS id."""
    extra = {"eos_token_id": eos} if eos is not None else {}
    return (dataclasses.replace(CLIPTextConfig.vit_l(), projection_dim=768, **extra),
            dataclasses.replace(CLIPTextConfig.sdxl_g(), **extra))


def sd3_full_setup(seed: int, batch_size: int, t5: bool = False) -> dict:
    """SD3-Medium's MMDiT at its published widths (2.03 B parameters, random
    from ``seed``) as the full_unet target under the JAX package's default
    optimizer (AdamW, fp32 masters, no moment dtype: the kernel's xla
    rounding), the pos_embed table frozen in bf16; with ``t5`` the two CLIP
    towers and T5-XXL v1.1's encoder frozen in bf16 beside it."""
    mm = MMDiTConfig.sd3_medium()
    config = merge(default(), Config({
        "batch_size": batch_size, "trainer": {"precision": "bf16"},
        "uncond": {"enabled": t5, "p": 0.1, "cond": "eos"},
        "optimizer": {"name": "adamw", "params": {"lr": SD3_LR, "weight_decay": 1e-2},
                      "lr_scale": {"enabled": False}}}))
    params = init_mmdit_params(mm, seed=seed + 40, device=DEVICE)
    resolutions = resolve_optim_target(load_optim_target("full_unet"), params.keys(), [])
    trainable = {f"unet.{k}": params.pop(k) for k in resolutions["unet"].trainable}
    frozen = {f"unet.{k}": v.bfloat16() for k, v in params.items()}
    check(list(frozen) == ["unet." + POS_EMBED_KEY], f"frozen MMDiT leaves {list(frozen)}")
    del params
    labels = group_labels(resolutions)
    overrides = {f"g{i}": g.optimizer for i, g in enumerate(resolutions["unet"].groups)}
    tx, lr_fn = build_optimizer(config, labels, overrides, steps_per_epoch=1000, num_processes=1)
    check(all(t.xla for t in tx.transforms.values()), "the default AdamW is not in xla mode")
    clip1 = clip2 = t5_config = None
    if t5:
        clip1, clip2 = sd3_towers()
        t5_config = T5Config.t5_xxl()
        for i, (prefix, p) in enumerate((
                ("condition_model.encoder", init_clip_params(clip1, seed + 41, DEVICE,
                                                             torch.bfloat16)),
                ("condition_model.encoder_2", init_clip_params(clip2, seed + 42, DEVICE,
                                                               torch.bfloat16)),
                ("condition_model.encoder_3", init_t5_params(t5_config, seed + 43, DEVICE,
                                                             torch.bfloat16)))):
            frozen.update({f"{prefix}.{k}": v for k, v in p.items()})
    spec = StepSpec.from_config(config, None, FlowSchedule(), clip_config=clip1,
                                clip2_config=clip2, mmdit_config=mm, t5_config=t5_config)
    state = init_train_state(trainable, tx, seed=seed)
    return {"state": state, "frozen": frozen, "tx": tx, "spec": spec,
            "step_fn": make_train_step(spec, tx, lr_fn), "mmdit": mm}


def sd3_latents(gen: torch.Generator, batch: int) -> torch.Tensor:
    lat = SD3_RESOLUTION // 8
    return torch.randn(batch, 16, lat, lat, generator=gen, device=DEVICE)


def sd3_splash_per_step(mm: MMDiTConfig) -> dict[str, int]:
    """Each splash kernel once per block per step: the joint attention at
    L = 4096 + the context, which the gate admits (no remat)."""
    return {name: mm.num_layers for name in SPLASH}


@torch.no_grad()
def sd3_check_forward(state, frozen: dict, batch: dict, mm: MMDiTConfig) -> dict:
    """One MMDiT forward on one sample with the kernels and with the plain
    attention path (FORCE_MATH), on the trained masters in bf16: within the
    check phase's bound."""
    params = {k[len("unet."):]: v.bfloat16() for k, v in {**frozen, **state.trainable}.items()
              if k.startswith("unet.")}
    x, ctx, pooled = (batch[k][:1].bfloat16() for k in ("latents", "conds", "pooled"))
    t = torch.tensor([500.0], device=DEVICE)
    with_kernels = mmdit_apply(params, x, t, ctx, pooled, mm)
    attention.FORCE_MATH = True
    try:
        plain = mmdit_apply(params, x, t, ctx, pooled, mm)
    finally:
        attention.FORCE_MATH = False
    check(with_kernels.shape == x.shape and bool(torch.isfinite(with_kernels).all()),
          f"MMDiT output {tuple(with_kernels.shape)}, finite {torch.isfinite(with_kernels).all()}")
    err = rel_err(with_kernels, plain)
    check(err <= CHECK_TOL, f"MMDiT output, kernel path vs plain path: {err}")
    return {"mmdit_rel_err": err}


def sd3_cached_phase(seed: int, steps: int, gen: torch.Generator) -> dict:
    """The cached SD3 step at 1024^2, batch 2: latents (2, 16, 128, 128),
    conds (2, 154, 4096) and pooled (2, 2048) from the generator; 2 warm-up
    and ``steps`` timed steps, the launches counted over the timed ones
    (each splash kernel 24 per step, adam_bf16_fused once);
    then one MMDiT forward against the plain attention path."""
    s = sd3_full_setup(seed, SD3_BATCH)
    mm, state = s["mmdit"], s["state"]
    batch = {"latents": sd3_latents(gen, SD3_BATCH),
             "conds": torch.randn(SD3_BATCH, SD3_CONTEXT, mm.joint_attention_dim,
                                  generator=gen, device=DEVICE),
             "pooled": torch.randn(SD3_BATCH, mm.pooled_projection_dim, generator=gen,
                                   device=DEVICE)}
    per_step = {**sd3_splash_per_step(mm), **optimizer_launches(state.opt_state),
                "ema_fused": 0}
    probe = [k for k in sorted(state.trainable) if k.endswith("attn.to_q.weight")][:3]
    res = run_steps(state, s["step_fn"], s["frozen"], lambda: batch, steps, 2, per_step,
                    probe=probe + ["unet.proj_out.weight"])
    res["param_groups"] = len(s["tx"].transforms)
    res["trainable_params"] = sum(v.numel() for v in res["state"].trainable.values())
    res["check"] = sd3_check_forward(res.pop("state"), s["frozen"], batch, mm)
    del s, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sd3_ids(gen: torch.Generator, batch: int) -> dict[str, torch.Tensor]:
    """Prompt ids of both tokenizers' forms from the generator: CLIP's BOS,
    words, EOS padding (77); T5's words, EOS 1, pad 0 (77); the empty
    prompts' ids of each."""
    clip = torch.full((batch, 77), 49407, dtype=torch.int64, device=DEVICE)
    t5 = torch.zeros((batch, 77), dtype=torch.int64, device=DEVICE)
    for b in range(batch):
        n = int(torch.randint(5, 60, (), generator=gen, device=DEVICE))
        clip[b, 0] = 49406
        clip[b, 1:n + 1] = torch.randint(0, 49406, (n,), generator=gen, device=DEVICE)
        t5[b, :n] = torch.randint(3, 32100, (n,), generator=gen, device=DEVICE)
        t5[b, n] = 1
    uncond = torch.full((1, 77), 49407, dtype=torch.int64, device=DEVICE)
    uncond[0, 0] = 49406
    t5_uncond = torch.zeros((1, 77), dtype=torch.int64, device=DEVICE)
    t5_uncond[0, 0] = 1
    return {"input_ids": clip, "uncond_ids": uncond, "t5_ids": t5, "t5_uncond_ids": t5_uncond}


def sd3_triple_phase(seed: int, steps: int, gen: torch.Generator) -> dict:
    """The triple-encoder SD3 step at 1024^2, batch 1: CLIP-L, CLIP-G and
    T5-XXL v1.1's encoder at published widths, frozen in bf16, encode ids
    drawn from the generator (no tokenizer), CFG dropout 'eos' at 0.1; the
    MMDiT trains under the default AdamW (fp32 masters and moments). 2
    warm-up and ``steps`` timed steps: splash 24 per step each (CLIP's
    causal and T5's biased attention take the math path), adam_bf16_fused
    once."""
    s = sd3_full_setup(seed, SD3_TRIPLE_BATCH, t5=True)
    mm, state = s["mmdit"], s["state"]
    batch = {"latents": sd3_latents(gen, SD3_TRIPLE_BATCH), **sd3_ids(gen, SD3_TRIPLE_BATCH)}
    per_step = {**sd3_splash_per_step(mm), **optimizer_launches(state.opt_state),
                "ema_fused": 0}
    probe = [k for k in sorted(state.trainable) if k.endswith("attn.to_q.weight")][:3]
    res = run_steps(state, s["step_fn"], s["frozen"], lambda: batch, steps, 2, per_step,
                    probe=probe + ["unet.context_embedder.weight"])
    del res["state"]
    res["frozen_params"] = sum(v.numel() for v in s["frozen"].values())
    res["ran"] = (f"batch {SD3_TRIPLE_BATCH} at {SD3_RESOLUTION}^2, MMDiT trained with fp32 "
                  "masters and moments (AdamW, no moment dtype), CLIP-L + CLIP-G + T5-XXL "
                  "frozen in bf16 (T5 computes in fp32), context 154 tokens")
    del s, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def write_square_images(root: Path, name: str, n: int, size: int, seed: int) -> Path:
    """``n`` PNGs of random pixels at size x size, with captions."""
    from PIL import Image

    d = root / name
    d.mkdir(parents=True)
    r = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(r.randint(0, 256, (size, size, 3), np.uint8)).save(d / f"img_{i:03d}.png")
        (d / f"img_{i:03d}.txt").write_text(f"a photo of the cat number {i}")
    return d


def write_sd3_dir(root: Path, seed: int) -> Path:
    """A diffusers directory of SD3-Medium at its published widths in bf16
    without text_encoder_3/ (SD3 without T5), random weights from ``seed``:
    transformer/ (the MMDiT), the 16-channel VAE, both projected CLIP towers
    (EOS the synthetic vocab's), the flow scheduler and the synthetic
    vocab."""
    d = root / "sd3"
    tok = write_vocab(d / "tokenizer")
    clip1, clip2 = sd3_towers(eos=len(json.loads((tok / "vocab.json").read_text())) - 1)
    mm = MMDiTConfig.sd3_medium()
    parts = {"transformer": (mm, init_mmdit_params), "vae": (SD3_VAE, init_vae_params),
             "text_encoder": (clip1, init_clip_params),
             "text_encoder_2": (clip2, init_clip_params)}
    for i, (name, (cfg, init)) in enumerate(parts.items()):
        params = init(cfg, seed=seed + 50 + i, device=DEVICE, dtype=torch.bfloat16)
        (d / name).mkdir()
        save_state_dict(params, d / name / "diffusion_pytorch_model.safetensors")
        (d / name / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
        del params
    torch.cuda.empty_cache()
    (d / "scheduler").mkdir()
    (d / "scheduler" / "scheduler_config.json").write_text(json.dumps(SD3_SCHEDULER))
    return d


def sd3_cli_phase(seed: int, workdir: Path) -> dict:
    """SD3 through the CLIs: an SD3-Medium directory without T5 (written
    here), ``python -m scal_sdt_tpu_torch.cli.train`` with optim_target
    lora_sd3 (rank 16 on every joint-block projection: 285 groups) uncached
    at 1024^2, batch 1, SD3_CLI_STEPS steps ending on a checkpoint; then
    ``cli.sample`` with that checkpoint: one 1024^2 image by flow_euler at
    28 steps. Each train step launches each splash kernel 24 times (L = 4096
    + 77), adam_bf16_fused 285; the image 672 splash_fwd and nothing else."""
    t0 = time.perf_counter()
    model = write_sd3_dir(workdir, seed)
    images = write_square_images(workdir, "sd3_images", SD3_IMAGES, SD3_RESOLUTION, seed + 50)
    write_s = time.perf_counter() - t0
    gib = sum(p.stat().st_size for p in model.rglob("*") if p.is_file()) / 2 ** 30
    mm, (clip1, _) = MMDiTConfig.sd3_medium(), sd3_towers()
    groups = len(lora_groups("lora_sd3", {"unet": mmdit_param_shapes(mm),
                                          "text_encoder": clip_param_shapes(clip1)}))
    config = merge(default(), Config({
        "model": str(model), "output_dir": str(workdir / "sd3_runs"), "project": "sd3_lora",
        "seed": seed, "num_workers": NUM_WORKERS, "batch_size": 1,
        "optim_target": "lora_sd3",
        "data": {"resolution": SD3_RESOLUTION, "concepts": [
            {"instance_set": {"path": str(images), "prompt": "{TXT_PROMPT}"}}]},
        "trainer": {"precision": "bf16", "max_steps": SD3_CLI_STEPS, "log_every_n_steps": 1},
        "optimizer": {"lr_scale": {"enabled": False}},
        "loggers": {"tensorboard": None},
        "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None,
                       "every_n_train_steps": None, "monitor": None}}))
    cfg_path = workdir / "sd3_lora.yaml"
    cfg_path.write_text(json.dumps(config))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as run:
        train_cli.main(["--config", str(cfg_path), "--run-id", "r", "--device", DEVICE],
                       standalone_mode=False)
    launches = read_launches()
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    losses = run.losses()
    check(sorted(losses) == list(range(1, SD3_CLI_STEPS + 1))
          and all(math.isfinite(x) for x in losses.values()), f"SD3 lora losses {losses}")
    want = {**{k: mm.num_layers * SD3_CLI_STEPS for k in SPLASH},
            "adam_bf16_fused": ADAM_PER_STEP * SD3_CLI_STEPS, "adam8_fused": 0,
            "ema_fused": 0}
    check(launches == want, f"SD3 lora launches {launches}, expected {want}")
    (ckpt,) = (workdir / "sd3_runs" / "sd3_lora" / "r").glob("*.safetensors")
    factors = [k for k in load_state_dict(ckpt) if k.endswith((".lora_A", ".lora_B"))]
    check(len(factors) == 2 * groups, f"the SD3 LoRA checkpoint holds {len(factors)} factors")
    dts = [1.0 / m["steps_per_sec"] for s, m, _ in run.steps if s != 1]

    out = workdir / "sd3_samples"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    sample_cli.main(["--model", str(model), "--ckpt", str(ckpt), "--prompt",
                     "a photo of the cat number 1", "--negative", "blurry", "--steps",
                     str(SD3_SAMPLE_STEPS), "--cfg", "7", "--seed", "114514", "--width",
                     str(SD3_RESOLUTION), "--height", str(SD3_RESOLUTION), "--method",
                     "flow_euler", "--out", str(out), "--device", DEVICE], standalone_mode=False)
    sample_s = time.perf_counter() - t0
    sample_launches = read_launches()
    sample_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (png,) = sorted(out.glob("*.png"))
    pixels = png_pixels(png, (SD3_RESOLUTION, SD3_RESOLUTION))
    per_image = SD3_SAMPLE_STEPS * mm.num_layers
    check(sample_launches["splash_fwd"] == per_image
          and sum(sample_launches.values()) == per_image,
          f"SD3 sample launches {sample_launches}, expected splash_fwd {per_image} only")
    gc.collect()
    torch.cuda.empty_cache()
    return {"write_s": write_s, "dir_gib": gib, "groups": groups,
            "losses": [losses[s] for s in sorted(losses)],
            "steps_per_s": len(dts) / sum(dts) if dts else float("nan"),
            "first_step_s": run.steps[0][2], "train_peak_mem_gib": train_peak,
            "launches": launches,
            "launches_per_step": {k: v / SD3_CLI_STEPS for k, v in launches.items()},
            "checkpoint_mib": ckpt.stat().st_size / 2 ** 20,
            "sample_s": sample_s, "sample_launches": sample_launches,
            "sample_peak_mem_gib": sample_peak, "pixel_mean": float(pixels.mean())}


def sd3_adam_case(gen: torch.Generator) -> dict:
    """adam_bf16_fused in the cached SD3 step's form: one grouped launch in
    the xla mode over SD3-Medium's MMDiT leaves (fp32 masters and moments,
    bf16 gradients), bit for bit against its plain chain. Timed by CUDA
    events: the 18 ms launch dwarfs the host's upload of 682 addresses, and
    a torch.profiler trace after the SDXL phases' held none of its kernels."""
    shapes = mmdit_param_shapes(MMDiTConfig.sd3_medium())
    del shapes[POS_EMBED_KEY]
    keys = sorted(shapes)
    res = adamw_group_case(gen, [f"unet.{k}" for k in keys], [tuple(shapes[k]) for k in keys],
                           xla=True, traced=False)
    torch.cuda.empty_cache()
    return res


def sd3_phases(record: dict, args, gen: torch.Generator, rate: tuple[int, float],
               workdir: Path) -> None:
    """The sd3 phase in its parts, each timed and printed: (a) the splash
    kernels in SD3's forms, (b) the cached step at 1024^2, batch 2, (c) the
    triple-encoder step with T5, (d) the train and sample CLIs, then
    adam_bf16_fused in the cached step's form."""
    t0 = time.perf_counter()
    record["kernels_sd3"] = [kernel_phase(s, gen, rate) for s in SD3_KERNEL_SHAPES]
    for r in record["kernels_sd3"]:
        log(f"kernels (sd3) {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")
    log(f"sd3 kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    c = record["sd3_cached"] = sd3_cached_phase(args.seed, args.steps, gen)
    c["seconds"] = time.perf_counter() - t0
    log(f"sd3 cached step (SD3-Medium MMDiT, {c['trainable_params']} trainable, 1024^2, batch "
        f"{SD3_BATCH}, AdamW fp32 masters and moments): {c['steps_per_s']:.4f} steps/s over "
        f"{c['steps']} steps after 2 warm-up ({c['warmup_s']:.2f} s), peak "
        f"{c['peak_mem_gib']:.2f} GiB, launches per step "
        f"{ {k: v / c['steps'] for k, v in c['launches'].items()} } ({c['param_groups']} "
        f"groups), losses {c['losses']}, MMDiT kernel path vs plain {c['check']['mmdit_rel_err']:.3e} "
        f"(bound {CHECK_TOL}); phase {c['seconds']:.1f} s")

    t0 = time.perf_counter()
    x = record["sd3_triple"] = sd3_triple_phase(args.seed, SD3_TRIPLE_STEPS, gen)
    x["seconds"] = time.perf_counter() - t0
    log(f"sd3 triple-encoder step ({x['ran']}; {x['frozen_params']} frozen): "
        f"{x['steps_per_s']:.4f} steps/s over {x['steps']} steps, peak "
        f"{x['peak_mem_gib']:.2f} GiB, launches per step "
        f"{ {k: v / x['steps'] for k, v in x['launches'].items()} }, losses {x['losses']}; "
        f"phase {x['seconds']:.1f} s")

    t0 = time.perf_counter()
    d = record["sd3_cli"] = sd3_cli_phase(args.seed, workdir)
    d["seconds"] = time.perf_counter() - t0
    log(f"sd3 cli: wrote SD3-Medium without T5 ({d['dir_gib']:.2f} GiB, bf16) in "
        f"{d['write_s']:.1f} s; cli.train lora_sd3 ({d['groups']} groups) at 1024^2, batch 1: "
        f"{d['steps_per_s']:.4f} steps/s, first step after {d['first_step_s']:.2f} s, peak "
        f"{d['train_peak_mem_gib']:.2f} GiB, launches per step {d['launches_per_step']}, "
        f"losses {d['losses']}, checkpoint {d['checkpoint_mib']:.2f} MiB; cli.sample one 1024^2 "
        f"image by flow_euler at {SD3_SAMPLE_STEPS} steps in {d['sample_s']:.2f} s, launches "
        f"{d['sample_launches']}, peak {d['sample_peak_mem_gib']:.2f} GiB; phase "
        f"{d['seconds']:.1f} s")

    a = record["sd3_adam"] = sd3_adam_case(gen)
    log(f"sd3 kernels: adam_bf16_fused (xla mode) over the MMDiT's {a['leaves']} fp32 leaves "
        f"({a['elements']} elements): {a['ms']:.4f} ms (bound {a['bound'][0]:.4f} ms by "
        f"{a['bound'][1]}, {a['bytes'] / 1e9:.3f} GB), call {a['call_ms']:.4f} ms, plain "
        f"{a['plain_ms']:.2f} ms, bit-equal {a['err']}")


SD21_RESOLUTION, SD21_BATCH = 768, 2
SD21_IMAGES = 4                    # 768^2 PNGs: two steps an epoch at batch 2
SD21_WARMUP = 2                    # untimed steps before the --steps timed ones
SD21_SAMPLE_STEPS, SD21_CFG = 28, 7.5
# splash's forms at 768^2, batch 2 (levels 0 and 1; level 2's L = 576 takes
# the math path), then at 512^2
SD21_FORMS = [(2, 5, 9216, 64), (2, 10, 2304, 64)]
SD21_KERNEL_SHAPES = SD21_FORMS + [(2, 5, 4096, 64), (2, 10, 1024, 64)]
SINGLE_FILE_STEPS = 2              # leg (a): cached steps from the SD1.5 file
EXTRACT_CHECKED = 3                # leg (d): leaves held against a float64 CPU SVD
EXTRACT_TOL, EXTRACT_FRO_TOL = 1e-4, 1e-3
# OpenCLIP ViT-H/14's text tower (SD2.x's cond_stage_model.model): 24
# resblocks, width 1024, gelu
OPENCLIP_H = CLIPTextConfig(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                            num_attention_heads=16, hidden_act="gelu")
# the numbers of Stability AI's configs/stable-diffusion/v2-inference-v.yaml
# (Stability-AI/stablediffusion) that the loader reads
SD21_V_YAML = {"model": {"params": {
    "parameterization": "v", "linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000,
    "scale_factor": 0.18215,
    "unet_config": {"params": {
        "in_channels": 4, "out_channels": 4, "model_channels": 320,
        "attention_resolutions": [4, 2, 1], "num_res_blocks": 2, "channel_mult": [1, 2, 4, 4],
        "num_head_channels": 64, "use_spatial_transformer": True,
        "use_linear_in_transformer": True, "transformer_depth": 1, "context_dim": 1024}},
    "first_stage_config": {"params": {"embed_dim": 4, "ddconfig": {
        "double_z": True, "z_channels": 4, "resolution": 256, "in_channels": 3, "out_ch": 3,
        "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2, "attn_resolutions": []}}},
    "cond_stage_config": {"params": {"freeze": True, "layer": "penultimate"}}}}}


class SplashFormProbe:
    """The splash kernels' launches by form while the probe is open:
    (kernel, (B, H, Lq, D)) -> launches, read at the wrappers."""

    def __init__(self):
        self.forms: dict = {}

    def __enter__(self):
        self._real = {name: getattr(splash, name) for name in SPLASH}
        for name, fn in self._real.items():
            def counted(qs, *args, _name=name, _fn=fn):
                key = (_name, tuple(qs.shape))
                self.forms[key] = self.forms.get(key, 0) + 1
                return _fn(qs, *args)
            setattr(splash, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(splash, name, fn)

    def by_form(self) -> dict[str, dict[str, int]]:
        out: dict = {}
        for (name, shape), n in sorted(self.forms.items()):
            out.setdefault(str(list(shape)), {})[name] = n
        return out


def gib_of(*paths: Path) -> float:
    return sum(p.stat().st_size for p in paths) / 2 ** 30


def same_tensors(got: dict, want: dict, what: str) -> int:
    """Every tensor of ``want`` in ``got`` with equal values and dtype."""
    check(got.keys() == want.keys(), f"{what}: keys differ ({len(got)} against {len(want)})")
    bad = [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    check(not bad, f"{what}: {len(bad)} tensors differ, e.g. {bad[:3]}")
    return len(want)


def single_file_sd15(seed: int, workdir: Path, model: Path) -> dict:
    """Leg (a): SD1.5 from a single file. A training-layout file of the
    trainer phase's directory (its UNet under unet., its CLIP under
    condition_model.encoder.), published by ``ckpt_tool prune
    --text-encoder --df-vae <dir>/vae`` in fp32; ``load_components`` of the
    file (the bundled v1 YAML) gives every UNet, VAE and CLIP tensor of the
    directory, bit for bit after the exact fp32 widening. Then the train CLI
    from the file: SINGLE_FILE_STEPS cached steps at 512^2, batch 8, as the
    trainer phase runs them (the trainer phase's config and cache file; 10
    launches of each splash kernel per step);
    and the sample CLI from the file (``--tokenizer`` the directory's): one
    512^2 image at the shipped concept's settings, 280 splash_fwd and
    nothing else, its PNG equal to the directory's for the same seed."""
    from scal_sdt_tpu_torch.cli import ckpt_tool

    t0 = time.perf_counter()
    d = load_components(merge(default(), Config({"model": str(model)})))
    training = {**{f"unet.{k}": v for k, v in d.unet.items()},
                **{f"condition_model.encoder.{k}": v for k, v in d.clip.items()}}
    train_file, sd15_file = workdir / "sd15_train.safetensors", workdir / "sd15.safetensors"
    save_state_dict(training, train_file)
    del training
    ckpt_tool.main(["prune", str(train_file), str(sd15_file), "--text-encoder", "--df-vae",
                    str(model / "vae"), "--unet-dtype", "fp32", "--text-encoder-dtype", "fp32"],
                   standalone_mode=False)
    prune_s = time.perf_counter() - t0
    train_file.unlink()
    t0 = time.perf_counter()
    f = load_components(merge(default(), Config({"model": str(sd15_file)})))
    load_s = time.perf_counter() - t0
    check(f.unet_config == UNetConfig.sd15() and f.vae_config == VAEConfig.sd15()
          and f.clip_config == CLIPTextConfig.vit_l(), "the SD1.5 file's configs")
    widened = lambda p: {k: v.float() for k, v in p.items()}
    n = sum(same_tensors(getattr(f, c), widened(getattr(d, c)), f"the SD1.5 file's {c}")
            for c in ("unet", "vae", "clip"))
    del d, f

    config = merge(load_with_defaults(workdir / "trainer.yaml"), Config({
        "model": str(sd15_file), "output_dir": str(workdir / "sf_runs"), "project": "sf",
        "trainer": {"max_steps": SINGLE_FILE_STEPS, "max_epochs": 1},
        "checkpoint": {"every_n_train_steps": None, "every_n_epochs": None}}))
    cfg_path = workdir / "sf_train.yaml"
    cfg_path.write_text(json.dumps(config))
    torch.cuda.synchronize()
    reset_launches()
    with TrainerProbe() as run:
        train_cli.main(["--config", str(cfg_path), "--run-id", "r", "--device", DEVICE],
                       standalone_mode=False)
    train_launches = read_launches()
    gc.collect()
    torch.cuda.empty_cache()
    losses = run.losses()
    check(sorted(losses) == list(range(1, SINGLE_FILE_STEPS + 1))
          and all(math.isfinite(x) for x in losses.values()), f"SD1.5 file losses {losses}")
    want = {**{k: CALLS_PER_STEP * SINGLE_FILE_STEPS for k in SPLASH},
            "adam_bf16_fused": ADAM_PER_STEP * SINGLE_FILE_STEPS, "adam8_fused": 0,
            "ema_fused": 0}
    check(train_launches == want, f"SD1.5 file train launches {train_launches}, expected {want}")
    shutil.rmtree(workdir / "sf_runs")

    concept, clip_skip = shipped_concept()
    pngs, sample_s, sample_launches = {}, {}, {}
    for name, extra in (("file", ["--model", str(sd15_file), "--tokenizer",
                                  str(model / "tokenizer")]),
                        ("dir", ["--model", str(model)])):
        out = workdir / "sf_samples" / name
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        sample_cli.main(extra + ["--prompt", concept.prompt, "--negative", concept.negative_prompt,
                                 "--steps", str(concept.steps), "--cfg", str(concept.cfg_scale),
                                 "--seed", str(concept.seed), "--clip-skip", str(clip_skip),
                                 "--width", str(RESOLUTION), "--height", str(RESOLUTION),
                                 "--out", str(out), "--device", DEVICE], standalone_mode=False)
        sample_s[name] = time.perf_counter() - t0
        sample_launches[name] = read_launches()
        (png,) = sorted(out.glob("*.png"))
        png_pixels(png, (RESOLUTION, RESOLUTION))
        pngs[name] = png.read_bytes()
    per_image = int(concept.steps) * CALLS_PER_STEP
    check(sample_launches["file"]["splash_fwd"] == per_image
          and sum(sample_launches["file"].values()) == per_image,
          f"SD1.5 file sample launches {sample_launches['file']}, expected splash_fwd "
          f"{per_image} only")
    check(pngs["file"] == pngs["dir"], "the SD1.5 file's PNG differs from the directory's")
    file_gib = gib_of(sd15_file)
    sd15_file.unlink()
    return {"file_gib": file_gib, "prune_s": prune_s, "load_s": load_s, "tensors_equal": n,
            "train_losses": [losses[s] for s in sorted(losses)],
            "train_launches": train_launches, "sample_s": sample_s,
            "sample_launches": sample_launches["file"], "png_equal": True,
            # the main path's launches: the train and sample CLIs from the file
            "launches": {k: train_launches[k] + sample_launches["file"][k]
                         for k in train_launches}}


def write_sd21_file(root: Path, seed: int) -> tuple[Path, Path]:
    """SD2.1-768-v as one LDM file in fp32 (about 5 GB), random weights from
    ``seed`` at the published widths: the UNet (UNetConfig.sd21: heads 5, 10,
    20, 20, linear projections, context 1024) under model.diffusion_model.,
    SD's VAE under first_stage_model., OpenCLIP-H's text tower (24
    resblocks, its projection and logit scale) under cond_stage_model.model.;
    and the v2-inference-v YAML beside it."""
    from scal_sdt_tpu_torch.convert.sd_names import (convert_transformers_text_to_openclip,
                                                     convert_unet_state_df_to_ldm,
                                                     convert_vae_state_df_to_ldm)

    state = {}
    unet = init_unet_params(UNetConfig.sd21(), seed=seed + 60, device=DEVICE)
    state.update({f"model.diffusion_model.{k}": v.cpu() for k, v in
                  convert_unet_state_df_to_ldm(unet, UNetConfig.sd21()).items()})
    del unet
    vae = init_vae_params(VAEConfig.sd15(), seed=seed + 61, device=DEVICE)
    state.update({f"first_stage_model.{k}": v.cpu()
                  for k, v in convert_vae_state_df_to_ldm(vae).items()})
    del vae
    tower = init_clip_params(OPENCLIP_H, seed=seed + 62, device=DEVICE)
    oc = convert_transformers_text_to_openclip(tower)
    del tower
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 63)
    oc["text_projection"] = torch.randn(1024, 1024, generator=gen, device=DEVICE) / 32
    oc["logit_scale"] = torch.tensor(4.6052, device=DEVICE)
    state.update({f"cond_stage_model.model.{k}": v.cpu() for k, v in oc.items()})
    del oc
    torch.cuda.empty_cache()
    path, yaml = root / "sd21_768_v.safetensors", root / "v2-inference-v.yaml"
    save_state_dict(state, path)
    yaml.write_text(json.dumps(SD21_V_YAML))
    return path, yaml


def single_file_sd21(seed: int, steps: int, workdir: Path, vocab: Path) -> dict:
    """Leg (b): SD2.1-768-v from a single file at full width. ``load_components``
    with ``ldm_config`` the v2-inference-v YAML and ``schedule:
    {prediction_type: v}`` gives UNetConfig.sd21(), SD's VAE and a 23-layer
    tower. The train CLI from the file, uncached at 768^2 from SD21_IMAGES
    PNGs, batch 2, the default AdamW (fp32 masters and moments:
    adam_bf16_fused's xla mode), v-prediction: SD21_WARMUP + ``steps`` steps
    ending on a checkpoint; per step 5 launches of each splash kernel at
    each of SD21_FORMS and adam_bf16_fused once; losses
    finite, masters moved. The checkpoint with the loaded tower bundled in
    (trainable-only checkpoints leave frozen parts out) through ``ckpt_tool
    prune --arch sd2 --text-encoder --vae <file>``: at --unet-dtype fp32 the
    reloaded UNet is the trained masters bit for bit, at fp16 their fp16
    cast; the tower prunes back out with 23 resblocks. Then one 768^2 image
    by DDIM at SD21_SAMPLE_STEPS steps with CFG through
    ``sampler.sample_images`` on the reloaded fp32 file (the sample CLI
    takes no LDM YAML, in JAX too): 140 splash_fwd at each form. Returns the
    record and the files leg (d) reads (the base, its YAML, the pruned fp32
    file)."""
    from scal_sdt_tpu_torch.cli import ckpt_tool

    t0 = time.perf_counter()
    base, yaml = write_sd21_file(workdir, seed)
    write_s = time.perf_counter() - t0
    file_gib = gib_of(base)
    sd2 = {"ldm_config": str(yaml), "schedule": {"prediction_type": "v"}}
    t0 = time.perf_counter()
    m = load_components(merge(default(), Config({"model": str(base), **sd2})))
    load_s = time.perf_counter() - t0
    check(m.unet_config == UNetConfig.sd21() and m.vae_config == VAEConfig.sd15()
          and m.clip_config == dataclasses.replace(OPENCLIP_H, num_hidden_layers=23)
          and m.schedule.prediction_type == "v", f"the SD2.1 file's configs: {m.unet_config}, "
          f"{m.vae_config}, {m.clip_config}, {m.schedule.prediction_type}")
    tower = {f"condition_model.encoder.{k}": v for k, v in m.clip.items()}
    base_unet = m.unet
    del m

    images = write_square_images(workdir, "sd21_images", SD21_IMAGES, SD21_RESOLUTION, seed + 64)
    total = SD21_WARMUP + steps
    config = merge(default(), Config({
        "model": str(base), **sd2, "tokenizer": str(vocab),
        "output_dir": str(workdir / "sd21_runs"), "project": "sd21", "seed": seed,
        "num_workers": NUM_WORKERS, "batch_size": SD21_BATCH,
        "data": {"resolution": SD21_RESOLUTION, "concepts": [
            {"instance_set": {"path": str(images), "prompt": "{TXT_PROMPT}"}}]},
        "trainer": {"precision": "bf16", "max_steps": total, "max_epochs": total,
                    "log_every_n_steps": 1},
        "loggers": {"tensorboard": None},
        "checkpoint": {"filename": "last", "every_n_epochs": None, "every_n_train_steps": None,
                       "monitor": None}}))
    check(config.optimizer.name == "adamw" and not config.optimizer.get("master_dtype")
          and not config.optimizer.get("moment_dtype"), "the default optimizer changed")
    cfg_path = workdir / "sd21.yaml"
    cfg_path.write_text(json.dumps(config))
    groups = len(resolve_optim_target(load_optim_target("full_unet"),
                                      unet_param_shapes(UNetConfig.sd21()), [])["unet"].groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as run, SplashFormProbe() as forms:
        train_cli.main(["--config", str(cfg_path), "--run-id", "r", "--device", DEVICE],
                       standalone_mode=False)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc.collect()
    torch.cuda.empty_cache()
    losses = run.losses()
    check(sorted(losses) == list(range(1, total + 1))
          and all(math.isfinite(x) for x in losses.values()), f"SD2.1 losses {losses}")
    want_forms = {str(list(s)): {k: 5 * total for k in SPLASH} for s in SD21_FORMS}
    check(forms.by_form() == want_forms,
          f"SD2.1 splash launches by form {forms.by_form()}, expected {want_forms}")
    want = {**{k: 10 * total for k in SPLASH}, "adam_bf16_fused": ADAM_PER_STEP * total,
            "adam8_fused": 0, "ema_fused": 0}
    check(launches == want, f"SD2.1 train launches {launches}, expected {want}")
    dts = [1.0 / mt["steps_per_sec"] for s, mt, _ in run.steps if s > SD21_WARMUP]
    run_dir = workdir / "sd21_runs" / "sd21" / "r"
    ckpt = run_dir / "last.safetensors"
    ckpt_gib = gib_of(ckpt, Path(str(ckpt) + ".torchstate"))
    Path(str(ckpt) + ".torchstate").unlink()
    trained = load_state_dict(ckpt)
    masters = {k[len("unet."):]: v for k, v in trained.items() if k.startswith("unet.")}
    check(masters.keys() == base_unet.keys()
          and all(v.dtype == torch.float32 for v in masters.values()),
          "the SD2.1 checkpoint holds the fp32 masters of every UNet tensor")
    n_masters = len(masters)
    moved = sum(not torch.equal(masters[k], base_unet[k]) for k in masters)
    check(moved > n_masters // 2, f"SD2.1: {moved} of {n_masters} masters moved")
    del base_unet

    # a whole model to publish: the trained masters and the loaded tower
    bundled = workdir / "sd21_bundled.safetensors"
    save_state_dict({**trained, **tower}, bundled)
    del trained
    ckpt.unlink()
    pruned = {}
    t0 = time.perf_counter()
    for dtype in ("fp16", "fp32"):
        pruned[dtype] = workdir / f"sd21_pruned_{dtype}.safetensors"
        ckpt_tool.main(["prune", str(bundled), str(pruned[dtype]), "--arch", "sd2",
                        "--text-encoder", "--vae", str(base), "--unet-dtype", dtype,
                        "--text-encoder-dtype", "fp32"], standalone_mode=False)
    prune_s = time.perf_counter() - t0
    bundled.unlink()
    reloaded = {}
    for dtype, path in pruned.items():
        r = load_components(merge(default(), Config({"model": str(path), **sd2})))
        check(r.clip_config.num_hidden_layers == 23, "the pruned tower's depth")
        cast = {k: v.half() if dtype == "fp16" else v for k, v in masters.items()}
        same_tensors(r.unet, cast, f"the pruned {dtype} file's UNet")
        same_tensors(r.clip, {k[len("condition_model.encoder."):]: v for k, v in tower.items()},
                     f"the pruned {dtype} file's tower")
        reloaded[dtype] = r
    pruned_gib = {k: gib_of(p) for k, p in pruned.items()}
    pruned["fp16"].unlink()
    del masters, tower, reloaded["fp16"]

    r = reloaded.pop("fp32")
    spec = sampler.SamplerSpec(unet_config=r.unet_config, vae_config=r.vae_config,
                               clip_config=r.clip_config, schedule=r.schedule)
    params = [sampler.cast_params(p, spec.dtype, DEVICE) for p in (r.unet, r.vae, r.clip)]
    del r
    tokenizer = CLIPBPETokenizer.from_dir(vocab)
    kwargs = dict(steps=SD21_SAMPLE_STEPS, cfg_scale=SD21_CFG, width=SD21_RESOLUTION,
                  height=SD21_RESOLUTION, seed=seed, method="ddim", device=DEVICE)
    sampler.sample_images(*params, tokenizer, ["a photo of a cat"], "blurry", spec,
                          **{**kwargs, "steps": 2})   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    with SampleProbe() as probe, SplashFormProbe() as sample_forms:
        images = sampler.sample_images(*params, tokenizer, ["a photo of a cat"], "blurry", spec,
                                       **kwargs)
    sample_launches = read_launches()
    del params
    torch.cuda.empty_cache()
    check(images.shape == (1, SD21_RESOLUTION, SD21_RESOLUTION, 3)
          and all(c["finite"] for c in probe.calls), f"SD2.1 image {images.shape}, {probe.calls}")
    want_forms = {str(list(s)): {"splash_fwd": 5 * SD21_SAMPLE_STEPS} for s in SD21_FORMS}
    check(sample_forms.by_form() == want_forms
          and sum(sample_launches.values()) == sample_launches["splash_fwd"],
          f"SD2.1 sampling launches {sample_launches}, by form {sample_forms.by_form()}")
    record = {"write_s": write_s, "file_gib": file_gib, "load_s": load_s,
              "groups": groups, "steps": steps, "warmup": SD21_WARMUP,
              "losses": [losses[s] for s in sorted(losses)],
              "steps_per_s": len(dts) / sum(dts), "first_step_s": run.steps[0][2],
              "peak_mem_gib": peak,
              "launches_per_step": {k: v / total for k, v in launches.items()},
              "splash_by_form": forms.by_form(), "masters_moved": moved, "of": n_masters,
              "checkpoint_gib": ckpt_gib, "prune_s": prune_s, "pruned_gib": pruned_gib,
              "sample_s": probe.calls[0]["s"], "sample_launches": sample_launches,
              "sample_by_form": sample_forms.by_form(),
              # the main path's launches: the train CLI and the sampling call
              "launches": {k: launches[k] + sample_launches[k] for k in launches}}
    return record, (base, yaml, pruned["fp32"])


class LoraApproxProbe:
    """The device seconds (synchronized) of each of extract_lora's SVD calls
    while the probe is open."""

    def __init__(self):
        self.seconds: list[float] = []

    def __enter__(self):
        from scal_sdt_tpu_torch.cli import extract_lora

        self._module, self._real = extract_lora, extract_lora.lora_approx

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._real(*args)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        extract_lora.lora_approx = timed
        return self

    def __exit__(self, *exc):
        self._module.lora_approx = self._real


def single_file_extract(workdir: Path, base: Path, yaml: Path, trained: Path) -> dict:
    """Leg (d): ``python -m scal_sdt_tpu_torch.cli.extract_lora`` between leg
    (b)'s pruned fp32 file and the base file (``--ldm-config`` the SD2 YAML,
    lora_no-te.yaml, rank 16, fp32 factors; an SD2 file's tower is not read,
    as in JAX), its SVDs on the card, each timed. For EXTRACT_CHECKED leaves
    (the first, middle and last name), ``(alpha/rank) * up @ down`` of the
    written file against a float64 CPU SVD's rank-16 truncation of the same
    delta (read from the two files) within EXTRACT_TOL of the delta's
    largest entry, and the two truncations' Frobenius errors within
    EXTRACT_FRO_TOL relative of each other (Eckart-Young)."""
    from safetensors import safe_open

    from scal_sdt_tpu_torch.cli import extract_lora
    from scal_sdt_tpu_torch.convert.sd_names import unet_name_map

    out = workdir / "sd21_lora.safetensors"
    t0 = time.perf_counter()
    with LoraApproxProbe() as probe:
        extract_lora.main([str(trained), str(base), str(out), "--ldm-config", str(yaml),
                           "--layer-spec", str(CONFIGS_DIR / "optim_targets" / "lora_no-te.yaml"),
                           "--dtype", "fp32", "--device", DEVICE], standalone_mode=False)
    total_s = time.perf_counter() - t0
    lora = load_state_dict(out)
    out.unlink()
    names = sorted(k[:-len(".lora_down.weight")] for k in lora if k.endswith(".lora_down.weight"))
    check(len(names) == len(probe.seconds) > 0 and len(lora) == 3 * len(names),
          f"extract_lora wrote {len(lora)} tensors for {len(names)} leaves "
          f"({len(probe.seconds)} SVDs)")
    shapes = unet_param_shapes(UNetConfig.sd21())
    ldm_names = unet_name_map(UNetConfig.sd21(), shapes)
    paths = {"lora_unet_" + k[:-len(".weight")].replace(".", "_"): k
             for k in shapes if k.endswith(".weight")}
    checked = []
    for name in (names[0], names[len(names) // 2], names[-1])[:EXTRACT_CHECKED]:
        key = "model.diffusion_model." + ldm_names[paths[name]]
        w = []
        for path in (trained, base):
            with safe_open(str(path), framework="pt") as f:
                w.append(f.get_tensor(key).float())
        delta = (w[0] - w[1]).reshape(w[0].shape[0], -1).double()   # a 1x1 conv as 2-D
        down, up = lora[f"{name}.lora_down.weight"], lora[f"{name}.lora_up.weight"]
        rank, alpha = down.shape[0], float(lora[f"{name}.alpha"])
        got = (alpha / rank) * (up.double() @ down.double())
        u, s, vt = torch.linalg.svd(delta, full_matrices=False)
        want = (u[:, :rank] * s[:rank]) @ vt[:rank]
        err = float((got - want).abs().max() / delta.abs().max())
        fro_got, fro_want = (float(torch.linalg.norm(delta - x)) for x in (got, want))
        fro_rel = abs(fro_got - fro_want) / fro_want
        checked.append({"leaf": name, "shape": list(delta.shape), "rank": rank,
                        "max_abs_rel": err, "fro_rel": fro_rel,
                        "sigma_gap": float((s[rank - 1] - s[rank]) / s[0])})
        log(f"extract_lora check: {checked[-1]}")
        check(err <= EXTRACT_TOL and fro_rel <= EXTRACT_FRO_TOL,
              f"extract_lora {name}: {err:.3e} of the delta's largest entry (bound "
              f"{EXTRACT_TOL}), Frobenius errors {fro_got:.6e} / {fro_want:.6e}")
    return {"leaves": len(names), "total_s": total_s, "svd_s": sum(probe.seconds),
            "svd_ms_per_leaf": 1e3 * sum(probe.seconds) / len(probe.seconds),
            "svd_ms_max": 1e3 * max(probe.seconds), "checked": checked}


def single_file_phase(record: dict, args, gen: torch.Generator, rate: tuple[int, float],
                      workdir: Path) -> None:
    """The single_file phase in its legs, each timed and printed: (a) SD1.5
    from a single file, (b) SD2.1-768-v from a single file, (c) splash in
    SD2.x's forms, (d) extract_lora on the card; its files are deleted as
    it goes."""
    t0 = time.perf_counter()
    a = single_file_sd15(args.seed, workdir, workdir / "model")
    a["seconds"] = time.perf_counter() - t0
    log(f"single_file (a) SD1.5: prune --text-encoder --df-vae to a {a['file_gib']:.2f} GiB fp32 "
        f"file in {a['prune_s']:.1f} s, load_components {a['load_s']:.2f} s, "
        f"{a['tensors_equal']} tensors equal to the directory's; cli.train from the file: "
        f"losses {a['train_losses']}, launches {a['train_launches']}; cli.sample one 512^2 "
        f"image: {a['sample_s']['file']:.2f} s (directory {a['sample_s']['dir']:.2f} s), "
        f"launches {a['sample_launches']}, PNG equal to the directory's; leg "
        f"{a['seconds']:.1f} s")

    t0 = time.perf_counter()
    b, (base, yaml, trained) = single_file_sd21(args.seed, args.steps, workdir,
                                                workdir / "model" / "tokenizer")
    b["seconds"] = time.perf_counter() - t0
    log(f"single_file (b) SD2.1-768-v: wrote a {b['file_gib']:.2f} GiB fp32 file in "
        f"{b['write_s']:.1f} s, load_components {b['load_s']:.2f} s (UNetConfig.sd21, 23-layer "
        f"tower, v); cli.train uncached at 768^2, batch {SD21_BATCH}, AdamW fp32 masters and "
        f"moments ({b['groups']} groups): {b['steps_per_s']:.4f} steps/s over {b['steps']} "
        f"steps after {b['warmup']} warm-up, first step after {b['first_step_s']:.2f} s, peak "
        f"{b['peak_mem_gib']:.2f} GiB, launches per step {b['launches_per_step']}, splash by "
        f"form {b['splash_by_form']}, losses {b['losses']}, {b['masters_moved']} of {b['of']} "
        f"masters moved; checkpoint + sidecar {b['checkpoint_gib']:.2f} GiB; prune --arch sd2 "
        f"--text-encoder fp16 and fp32 in {b['prune_s']:.1f} s ({b['pruned_gib']} GiB), "
        f"reloaded bit for bit; DDIM {SD21_SAMPLE_STEPS} steps, cfg {SD21_CFG}, one 768^2 "
        f"image: {b['sample_s']:.2f} s, splash_fwd by form {b['sample_by_form']}; leg "
        f"{b['seconds']:.1f} s")

    t0 = time.perf_counter()
    record["kernels_sd21"] = [kernel_phase(s, gen, rate) for s in SD21_KERNEL_SHAPES]
    for r in record["kernels_sd21"]:
        log(f"kernels (sd2.x) {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")
    torch.cuda.empty_cache()
    # adam_bf16_fused in (b)'s form: the xla mode over SD2.1's UNet leaves
    shapes = unet_param_shapes(UNetConfig.sd21())
    keys = sorted(shapes)
    adam = record["sd21_adam"] = adamw_group_case(gen, [f"unet.{k}" for k in keys],
                                                  [tuple(shapes[k]) for k in keys], xla=True,
                                                  traced=False)
    torch.cuda.empty_cache()
    log(f"single_file (c) kernels in SD2.x's forms: adam_bf16_fused (xla mode) over SD2.1's "
        f"{adam['leaves']} fp32 leaves ({adam['elements']} elements): {adam['ms']:.4f} ms "
        f"(bound {adam['bound'][0]:.4f} ms by {adam['bound'][1]}), plain "
        f"{adam['plain_ms']:.2f} ms, bit-equal {adam['err']}; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    d = single_file_extract(workdir, base, yaml, trained)
    d["seconds"] = time.perf_counter() - t0
    log(f"single_file (d) extract_lora (lora_no-te.yaml, rank 16) on the card: {d['leaves']} "
        f"leaves, SVDs {d['svd_s']:.3f} s in total ({d['svd_ms_per_leaf']:.2f} ms per leaf, "
        f"largest {d['svd_ms_max']:.2f} ms), the CLI {d['total_s']:.1f} s; against float64 CPU "
        f"truncations: {d['checked']}")
    for p in (base, yaml, trained):
        p.unlink()
    for sub in ("sd21_runs", "sd21_images", "sf_samples"):
        shutil.rmtree(workdir / sub, ignore_errors=True)
    record["single_file"] = {"sd15": a, "sd21": b, "extract": d,
                             "seconds": a["seconds"] + b["seconds"] + d["seconds"],
                             "launches": {k: a["launches"][k] + b["launches"][k]
                                          for k in a["launches"]}}


# --- the parallel phase: the mesh over torch.distributed -------------------------------

PARALLEL_STEPS = 2
# (data, fsdp, tensor) on 2 ranks; (2, 1, 1), the gradient all-reduce alone,
# was cut to keep the smoke inside its time limit: (1, 2, 1) runs it too
PARALLEL_MESHES = ((1, 2, 1), (1, 1, 2))
PARALLEL_LR = 1e-4         # large enough that 2 Adam steps move every master measurably
PARALLEL_TP_SHAPE = (8, 4, 4096, 40)   # splash at tensor 2: 8 shared rows, 4 of 8 heads
# a world's masters after PARALLEL_STEPS against the single process's, at bf16
# compute: every element within PARALLEL_CLOSE of its tensor's largest entry plus
# 2 lr per step, at most PARALLEL_FAR_SHARE of them beyond the first term, the
# update deltas within PARALLEL_DELTA_TOL relative L2, losses within
# PARALLEL_LOSS_TOL relative. The planted fault PARALLEL_FAULT (a world that does
# not sum its tensor-parallel partial gradients) must fail the share and delta
# bounds: the per-element and loss bounds alone pass it. On an H100 the sound
# worlds read a share of 1.6-2.1e-3 and deltas of 0.026-0.032, the fault 0.146
# and 0.379 (scripts/chip_parallel_phase.py).
PARALLEL_CLOSE, PARALLEL_FAR_SHARE, PARALLEL_DELTA_TOL = 1e-4, 1e-2, 5e-2
PARALLEL_LOSS_TOL = 1e-2
PARALLEL_FAULT = ((1, 1, 2), "skip_tensor_sum")
PARALLEL_RANK_TIMEOUT = 420


def parallel_config(workdir: Path, model: Path, cache_path: Path, seed: int,
                    mesh: tuple[int, int, int] | None = None) -> dict:
    """SD1.5 at full width from the cache phase's file: 512^2, global batch
    8, the default AdamW (fp32 masters and moments, XLA's rounding) at
    PARALLEL_LR, bf16 compute, remat on (the ranks share one card)."""
    cfg = {"model": str(model), "output_dir": str(workdir / "par_runs"), "project": "smoke",
           "batch_size": 8, "seed": seed, "num_workers": NUM_WORKERS,
           "gradient_checkpointing": True,
           "data": {"resolution": RESOLUTION, "cache": str(cache_path)},
           "trainer": {"precision": "bf16", "max_epochs": 1, "max_steps": PARALLEL_STEPS,
                       "log_every_n_steps": 1},
           "ema": {"enabled": False},
           "optimizer": {"name": "adamw", "params": {"lr": PARALLEL_LR, "weight_decay": 1e-2},
                         "lr_scale": {"enabled": False}},
           "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    if mesh is not None:
        cfg["trainer"]["mesh"] = dict(zip(("data", "fsdp", "tensor"), mesh))
    return cfg


def state_bytes(trainer) -> int:
    """Bytes of the masters and optimizer state a rank holds."""
    def tensors(obj):
        if isinstance(obj, torch.Tensor):
            yield obj
        elif isinstance(obj, dict):
            for v in obj.values():
                yield from tensors(v)
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                yield from tensors(getattr(obj, f.name))
    return sum(t.numel() * t.element_size()
               for t in [*trainer.state.trainable.values(), *tensors(trainer.state.opt_state)])


def compare_masters(masters: dict, reference: Path, model: Path, steps: int,
                    device) -> dict:
    """``masters`` (prefixed keys) against the reference run's file, by the
    CPU tests' bound, and their update deltas from the model directory's
    initial weights against the reference's (relative L2), on ``device``."""
    from safetensors import safe_open

    far = total = 0
    excess = 0.0
    num = torch.zeros((), dtype=torch.float64, device=device)
    den = torch.zeros((), dtype=torch.float64, device=device)
    with safe_open(str(reference), "pt", device="cpu") as ref, \
            safe_open(str(model / "unet" / "diffusion_pytorch_model.safetensors"), "pt",
                      device="cpu") as init:
        for k, v in masters.items():
            got = v.detach().to(device, torch.float32)
            want = ref.get_tensor(k).to(device, torch.float32)
            w0 = init.get_tensor(k[len("unet."):]).to(device, torch.float32)
            d = (got - want).abs()
            close = PARALLEL_CLOSE * float(want.abs().max())
            far += int((d > close).sum())
            total += d.numel()
            excess = max(excess, float((d - close - 2 * PARALLEL_LR * steps).max()))
            num += (got - want).double().square().sum()
            den += (want - w0).double().square().sum()
    return {"leaves": len(masters), "far": far, "elements": total, "far_share": far / total,
            "max_excess": excess, "delta_num": float(num), "delta_den": float(den),
            "delta_rel_l2": math.sqrt(float(num) / max(float(den), 1e-300))}


def merge_checks(checks: list[dict]) -> dict:
    """``compare_masters``' readings of a world's ranks as one: the share of
    every rank's masters, the deltas' relative L2 over all of them."""
    far, total = sum(c["far"] for c in checks), sum(c["elements"] for c in checks)
    num, den = sum(c["delta_num"] for c in checks), sum(c["delta_den"] for c in checks)
    return {"far_share": far / total, "max_excess": max(c["max_excess"] for c in checks),
            "delta_rel_l2": math.sqrt(num / max(den, 1e-300))}


def plant_fault(parallel, fault: str) -> None:
    """A deliberately wrong world, for the bounds' negative control: the
    gradient reduction without the data-parallel all-reduce (``skip_dp``)
    or without the tensor group's sum of the partial gradients
    (``skip_tensor_sum``)."""
    drop = {"skip_dp": "dp", "skip_tensor_sum": "tensor"}[fault]
    real = parallel.reduce_grads

    def reduce_grads(grads):
        groups = parallel.mesh.groups
        parallel.mesh.groups = {k: v for k, v in groups.items() if k != drop}
        try:
            real(grads)
        finally:
            parallel.mesh.groups = groups
    parallel.reduce_grads = reduce_grads


def parallel_rank(job_path: str) -> None:
    """One rank of the parallel phase, under ``torch.distributed.run``: the
    port's Trainer on the job's config, device and backend (and its planted
    ``fault``, if any), PARALLEL_STEPS steps with the launch counts reset
    just before; writes its numbers (and its masters' comparison with the
    reference) as JSON."""
    job = json.loads(Path(job_path).read_text())
    rank = int(os.environ["RANK"])
    cfg = merge(default(), Config(job["config"]))
    tr = Trainer(cfg, Path(job["run_dir"]), device=job["device"], backend=job["backend"])
    if job.get("fault"):
        plant_fault(tr.parallel, job["fault"])
    dev = tr.device
    losses, rates = [], []
    real = tr._log
    tr._log = lambda m, s: (losses.append(m["train_loss"]), rates.append(m["steps_per_sec"]),
                            real(m, s))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    tr.fit(max_steps_override=PARALLEL_STEPS, final_save=False)
    torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0
    out = {"rank": rank, "mesh": list(tr.mesh.shape), "coord": list(tr.mesh.coord),
           "backend": tr.mesh.backend, "losses": losses, "steps_per_s": rates,
           "fit_s": fit_s, "launches": read_launches(),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "state_gib": state_bytes(tr) / 2 ** 30, "owned": len(tr.state.trainable),
           "trainable": len(tr.parallel.owner) if tr.parallel else len(tr.state.trainable),
           "grad_buckets": len(tr.parallel.grad_buckets) if tr.parallel else 0,
           "broadcast_buckets": len(tr.parallel.broadcast_buckets) if tr.parallel else 0,
           "check": compare_masters(tr.state.trainable, Path(job["reference"]),
                                    Path(job["config"]["model"]), PARALLEL_STEPS, dev)}
    Path(job["out"]).mkdir(parents=True, exist_ok=True)
    (Path(job["out"]) / f"rank{rank}.json").write_text(json.dumps(out))


def nccl_probe(job_path: str) -> None:
    """Two ranks of NCCL on one card: the all-reduce must fail."""
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("nccl")
    x = torch.ones(4, device="cuda:0")
    torch.distributed.all_reduce(x)
    torch.cuda.synchronize()
    Path(job_path).with_suffix(f".rank{rank}.ok").write_text(str(x.tolist()))


def cli_rank(out: str, cli_args: list[str]) -> None:
    """The train CLI under ``torch.distributed.run``, the launch counts reset
    just before it and read after it; an NCCL all-reduce first shows the
    group is NCCL's."""
    from scal_sdt_tpu_torch.parallel.mesh import LaunchEnv, init_process_group

    env = LaunchEnv.from_environ()
    init_process_group(torch.device("cuda", env.local_rank), None, env)
    x = torch.full((4,), float(env.rank + 1), device=f"cuda:{env.local_rank}")
    torch.distributed.all_reduce(x)
    backend = torch.distributed.get_backend()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as probe:
        t0 = time.perf_counter()
        train_cli.main(cli_args, standalone_mode=False)
        fit_s = time.perf_counter() - t0
    Path(out).write_text(json.dumps({
        "world": env.world, "backend": backend, "all_reduce": x.tolist(),
        "losses": probe.losses(), "steps_per_s": [m["steps_per_sec"] for _, m, _ in probe.steps],
        "cli_s": fit_s, "launches": read_launches(),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))


def torchrun(n: int, args: list[str], log_path: Path, timeout: int = PARALLEL_RANK_TIMEOUT
             ) -> subprocess.CompletedProcess:
    """``python -m torch.distributed.run --nproc_per_node n`` on one host,
    its output in ``log_path``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
           "--master_port", str(free_port()), *args]
    with open(log_path, "w") as f:
        return subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, timeout=timeout,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_phase(seed: int, workdir: Path, model: Path, cache_path: Path) -> dict:
    """The port's mesh at SD1.5 full width, 512^2, global batch 8,
    PARALLEL_STEPS steps, against the single process on the same global
    batch and draws (one generator seeded alike on every rank, each rank
    taking its rows): the reference run here; (a) one rank through the train
    CLI under torch.distributed.run over NCCL, the mesh resolved from the
    world size; NCCL's refusal of two ranks on one card; (b) two ranks on the
    card over gloo (given explicitly) for each mesh of PARALLEL_MESHES. Each
    rank's masters within the bounds of the reference's; PARALLEL_FAULT's
    world outside them. Two ranks that share one card over gloo (which
    stages each collective through host memory) measure correctness and
    memory, not multi-GPU speed."""
    here = Path(__file__).resolve()
    res: dict = {"note": "two ranks on one card over gloo: correctness and memory, not "
                         "multi-GPU speed"}
    cfg = parallel_config(workdir, model, cache_path, seed)
    ref_path = workdir / "parallel_reference.safetensors"
    # the single process
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with TrainerProbe() as probe:
        tr = Trainer(merge(default(), Config(cfg)), workdir / "par_ref", device=DEVICE)
        t0 = time.perf_counter()
        tr.fit(max_steps_override=PARALLEL_STEPS, final_save=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    launches = read_launches()
    res["single"] = {"losses": probe.losses(), "fit_s": fit_s,
                     "seconds": time.perf_counter() - t_phase,
                     "steps_per_s": [m["steps_per_sec"] for _, m, _ in probe.steps],
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "state_gib": state_bytes(tr) / 2 ** 30, "launches": launches}
    save_state_dict({k: v.float().cpu() for k, v in tr.state.trainable.items()}, ref_path)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    check(launches["splash_fwd"] > 0 and launches["adam_bf16_fused"] > 0,
          f"the reference run launched {launches}")
    total = {k: 0 for k in launches}

    # (a) one rank over NCCL through the train CLI
    t0 = time.perf_counter()
    cfg_path = workdir / "parallel_cli.yaml"
    cfg_path.write_text(json.dumps(dict(cfg, trainer=dict(cfg["trainer"], mesh={}))))
    out = workdir / "parallel_cli.json"
    proc = torchrun(1, [str(here), "--cli-rank", str(out), "--", "--config", str(cfg_path),
                        "--run-id", "par_cli"], workdir / "parallel_cli.log")
    check(proc.returncode == 0, "the train CLI under torch.distributed.run failed:\n"
          + (workdir / "parallel_cli.log").read_text()[-3000:])
    cli = json.loads(out.read_text())
    check(cli["backend"] == "nccl" and cli["all_reduce"] == [1.0] * 4, f"cli rank {cli}")
    ckpt = workdir / "par_runs" / "smoke" / "par_cli" / f"epoch=0-step={PARALLEL_STEPS}.safetensors"
    cli["check"] = compare_masters(load_state_dict(ckpt), ref_path, model, PARALLEL_STEPS,
                                   DEVICE)
    cli["seconds"] = time.perf_counter() - t0
    for f in checkpoint_files(ckpt.parent, ckpt.name[:-len(".safetensors")]):
        f.unlink()
    res["cli_nccl_1"] = cli
    for k, v in cli["launches"].items():
        total[k] += v

    # NCCL refuses two ranks on one card
    t0 = time.perf_counter()
    probe_job = workdir / "nccl_probe.json"
    probe_job.write_text("{}")
    try:
        proc = torchrun(2, [str(here), "--nccl-probe", str(probe_job)],
                        workdir / "nccl_probe.log", timeout=180)
        refused = proc.returncode != 0
    except subprocess.TimeoutExpired:
        refused = True
    text = (workdir / "nccl_probe.log").read_text()
    reason = [ln.strip() for ln in text.splitlines()
              if "Duplicate GPU" in ln or "ncclInvalidUsage" in ln or "NCCL error" in ln]
    res["nccl_two_ranks_one_card"] = {"refused": refused, "reason": reason[:3] or text[-600:],
                                      "seconds": time.perf_counter() - t0}
    check(refused, "NCCL ran two ranks on one card: gloo would not be needed")

    # (b) two ranks over gloo on the one card
    def world(mesh: tuple[int, int, int], fault: str | None = None) -> tuple[str, list]:
        t0 = time.perf_counter()
        name = "x".join(map(str, mesh)) + (f"_{fault}" if fault else "")
        job = {"config": parallel_config(workdir, model, cache_path, seed, mesh),
               "run_dir": str(workdir / f"par_{name}"), "device": "cuda:0", "backend": "gloo",
               "reference": str(ref_path), "out": str(workdir / f"par_{name}"), "fault": fault}
        job_path = workdir / f"parallel_{name}.json"
        job_path.write_text(json.dumps(job))
        proc = torchrun(2, [str(here), "--parallel-rank", str(job_path)],
                        workdir / f"parallel_{name}.log")
        check(proc.returncode == 0, f"mesh {mesh} failed:\n"
              + (workdir / f"parallel_{name}.log").read_text()[-3000:])
        ranks = [json.loads((workdir / f"par_{name}" / f"rank{r}.json").read_text())
                 for r in range(2)]
        for r in ranks:
            r["seconds"] = time.perf_counter() - t0
        return name, ranks

    for mesh in PARALLEL_MESHES:
        name, ranks = world(mesh)
        res[name] = ranks
        for r in ranks:
            for k, v in r["launches"].items():
                total[k] += v
    res["launches"] = total
    # the negative control (its launches are not the main path's)
    name, ranks = world(*PARALLEL_FAULT)
    res["fault"] = {"name": name, "ranks": ranks,
                    "check": merge_checks([r["check"] for r in ranks])}
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "parallel.json").write_text(json.dumps(res, indent=1))
    want = list(res["single"]["losses"].values())
    failed = []
    for name, runs in [("cli_nccl_1", [res["cli_nccl_1"]])] + [
            ("x".join(map(str, m)), res["x".join(map(str, m))]) for m in PARALLEL_MESHES]:
        for r in runs:
            c = r["check"]
            got = list(r["losses"].values()) if isinstance(r["losses"], dict) else r["losses"]
            if not (c["far_share"] <= PARALLEL_FAR_SHARE and c["max_excess"] <= 0
                    and c["delta_rel_l2"] <= PARALLEL_DELTA_TOL
                    and all(abs(a - b) <= PARALLEL_LOSS_TOL * abs(b) for a, b in zip(got, want))):
                failed.append(f"{name}: masters {c}, losses {got} against {want}")
    check(not failed, "; ".join(failed))
    f = res["fault"]["check"]
    check(f["far_share"] > PARALLEL_FAR_SHARE and f["delta_rel_l2"] > PARALLEL_DELTA_TOL,
          f"the bounds pass the planted fault {res['fault']['name']}: {f}")
    tp = res["1x1x2"]
    check(all(r["launches"]["splash_fwd"] > 0 for r in tp),
          "the tensor-parallel ranks launched no splash kernel")
    return res


def optim_entry(name: str, source: str, replaces: str, pallas_kernel: str,
                record: dict) -> dict:
    """The {"kernels": [...]} entry of an optimizer kernel: the numbers of its
    grouped launch over the SD1.5 leaves, the form the main path runs
    (adam8_fused: AdamW8bit's int8 leaves; adam_bf16_fused: AdamW's 686
    leaves), beside the update-only form at single leaves; launches from the
    phase whose main path it serves (adam8_fused: the int8 phase;
    adam_bf16_fused: the main train phase)."""
    cases = record["optim"][name]
    grouped = (record["optim"]["grouped_int8"]["adam8_fused"] if name == "adam8_fused"
               else record["optim"]["grouped"]["adam_bf16_fused"])
    opt = record["optim"]
    others = ({"grouped_fp32_grads": opt["grouped_int8_fp32_grads"]["adam8_fused"]}
              if name == "adam8_fused" else
              {"grouped_int8_fp32_leaves": opt["grouped_int8"]["adam_bf16_fused_fp32_leaves"],
               "grouped_fp32_grads": opt["grouped_fp32_grads"]["adam_bf16_fused"],
               "grouped_xla": opt["grouped_xla"]["adam_bf16_fused"],
               "sd3_grouped_xla": record["sd3_adam"],
               "sd21_grouped_xla": record["sd21_adam"],
               "grouped_int8_fp32_leaves_fp32_grads":
                   opt["grouped_int8_fp32_grads"]["adam_bf16_fused_fp32_leaves"]})
    phase = "train_int8" if name == "adam8_fused" else "train"
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "pallas_kernel": pallas_kernel,
            "launches": record[phase]["launches"][name],
            "launches_by_phase": {p: record[p]["launches"][name] for p in PHASES},
            "max_abs_err": max([r["err"]["out"] for r in cases] + [grouped["err"]["out"]]
                               + ([record[k][name]["err"]["out"]
                                   for k in ("lora_kernels", "sdxl_kernels")]
                                  + [record[k]["err"]["out"] for k in ("sd3_adam", "sd21_adam")]
                                  if name == "adam_bf16_fused" else [])),
            "ms": grouped["ms"], "plain_ms": grouped["plain_ms"],
            "bound_ms": grouped["bound"][0], "bound_by": grouped["bound"][1],
            "library_ms": grouped["library_ms"],
            "at": f"grouped: {grouped['leaves']} SD1.5 leaves, {grouped['elements']} elements",
            **{k: v for k, v in grouped.items() if k == "library"},
            **{k: {f: v[f] for f in ("leaves", "ms", "plain_ms", "bound", "library_ms")}
               for k, v in others.items()},
            **({"lora_groups": lora_record(record, "adam_bf16_fused"),
                "sdxl_lora_groups": lora_record(record, "adam_bf16_fused", kernels="sdxl_kernels")}
               if name == "adam_bf16_fused" else {}),
            "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound", "library_ms")}
                         for r in cases]}


def lora_record(record: dict, kernel: str, shadow: str | None = None,
                kernels: str = "lora_kernels") -> dict:
    """The kernels-line numbers of ``kernel`` in a LoRA phase's form (one
    launch per step over every LoRA group's fp32 masters; the EMA's with
    ``shadow``): the lora phase's, or with ``kernels="sdxl_kernels"`` the
    SDXL lora phase's."""
    lk = record[kernels]
    r = lk[kernel] if shadow is None else lk[kernel][shadow]
    return {"groups": lk["groups"] if shadow is None else r["groups"],
            **{f: r[f] for f in ("launches", "ms", "call_ms", "host_ms", "plain_ms", "bound",
                                 "library_ms") if f in r}}


def ema_entry(source: str, replaces: str, pallas_kernel: str, record: dict) -> dict:
    """The {"kernels": [...]} entry of the EMA kernel: its launch over the 686
    SD1.5 leaves with an fp32 shadow (the default ema.dtype), beside the
    bf16 shadow's; launches from the EMA phase's fp32 run."""
    k = record["ema"]["kernel"]
    main, other = k["fp32"], k["bf16"]
    return {"name": "ema_fused", "route": "cuda", "source": source, "replaces": replaces,
            "pallas_kernel": pallas_kernel,
            "launches": record["ema"]["launches"]["ema_fused"],
            "launches_by_phase": {p: record[p]["launches"]["ema_fused"] for p in PHASES},
            "max_abs_err": max([main["max_abs_err"], other["max_abs_err"]]
                               + [r["max_abs_err"]
                                  for r in record["lora_kernels"]["ema_fused"].values()]),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound"][0],
            "bound_by": main["bound"][1], "library_ms": main["library_ms"],
            "library": main["library"],
            "at": f"one launch over {main['leaves']} SD1.5 leaves, {main['elements']} elements, "
                  "fp32 shadows of bf16 masters",
            "bf16_shadow": {f: other[f] for f in ("ms", "plain_ms", "bound", "library_ms")},
            "ms_per_step": {name: record["ema"][name]["ema_ms_per_step"] for name in EMA_DTYPES},
            "lora_groups": {name: lora_record(record, "ema_fused", name) for name in EMA_DTYPES}}


def kernel_entries(record: dict) -> list[dict]:
    """The {"kernels": [...]} line's entries from the run's record: each
    splash kernel at the main path's long shape, with its other forms (ARB,
    lora, SDXL, sampling) beside it; the optimizer and EMA kernels from
    ``optim_entry`` and ``ema_entry``."""
    main_shape = record["kernels"][0]
    splash_records = (record["kernels"] + [record["kernels_arb"]] + record["kernels_lora"]
                      + record["kernels_sdxl"] + record["kernels_sd3"] + record["kernels_sd21"]
                      + [record["kernels_parallel"]])
    sampling_records = record["kernels_sampling"] + record["kernels_sdxl_sampling"]
    kernels = []
    for name, (source, replaces, pallas_kernel) in KERNELS.items():
        if name == "ema_fused":
            kernels.append(ema_entry(source, replaces, pallas_kernel, record))
            continue
        if name not in SPLASH:
            kernels.append(optim_entry(name, source, replaces, pallas_kernel, record))
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "pallas_kernel": pallas_kernel,
            "launches": record["train"]["launches"][name],
            "launches_by_phase": {p: record[p]["launches"][name] for p in PHASES},
            "max_abs_err": max([r["err"][name] for r in splash_records]
                               + ([r["err"] for r in sampling_records]
                                  if name == "splash_fwd" else [])),
            "ms": main_shape["ms"][name], "plain_ms": main_shape["plain_ms"][name],
            "bound_ms": main_shape["bound"][name][0],
            # the exponential unit's term counts as operations (of their
            # type, at its rate); bound_term names which term it was
            "bound_by": "bytes" if main_shape["bound"][name][1] == "bytes" else "operations",
            "bound_term": main_shape["bound"][name][1],
            "library_ms": main_shape["sdpa_fwd_ms" if name == "splash_fwd" else "sdpa_bwd_ms"],
            "library": "SDPA forward (F.scaled_dot_product_attention)" if name == "splash_fwd"
                       else SDPA_BWD,
            "at": main_shape["shape"],
            **({"sampling": [{k: r[k] for k in ("shape", "ms", "plain_ms", "sdpa_fwd_ms",
                                                "fwd_over_sdpa", "same_bits")}
                             | {"bound_ms": r["bound"][0]} for r in sampling_records]}
               if name == "splash_fwd" else {"bwd_pair_ms": main_shape["bwd_pair_ms"]}),
            "by_shape": [{"shape": r["shape"], "ms": r["ms"][name],
                          "device_ms": r["device_ms"][name],
                          "plain_ms": r["plain_ms"][name], "bound_ms": r["bound"][name][0],
                          "sdpa_fwd_ms": r["sdpa_fwd_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"],
                          "fwd_over_sdpa": r["fwd_over_sdpa"],
                          "bwd_pair_ms": r["bwd_pair_ms"],
                          "bwd_pair_over_sdpa": r["bwd_pair_over_sdpa"],
                          "fwd_same_bits": r["fwd_same_bits"],
                          "bwd_same_bits": r["bwd_same_bits"]}
                         for r in splash_records],
        })
    return kernels


def ptxas_lines(build_log: str) -> list[str]:
    """nvcc's report, one line per kernel instance: its (mangled) name with
    its registers, and its stack and spill bytes; the ``== source`` headers."""
    out, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif line.startswith("=="):
            out.append(line.strip())
        elif name and ("registers" in line or "spill" in line):
            out.append(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5)
    # the parallel phase's child processes (under torch.distributed.run)
    parser.add_argument("--parallel-rank", help=argparse.SUPPRESS)
    parser.add_argument("--cli-rank", help=argparse.SUPPRESS)
    parser.add_argument("--nccl-probe", help=argparse.SUPPRESS)
    parser.add_argument("--tune-rank", help=argparse.SUPPRESS)
    parser.add_argument("cli_args", nargs="*", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this smoke test runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.parallel_rank:
        parallel_rank(args.parallel_rank)
        return 0
    if args.cli_rank:
        cli_rank(args.cli_rank, args.cli_args)
        return 0
    if args.nccl_probe:
        nccl_probe(args.nccl_probe)
        return 0
    if args.tune_rank:
        tune_rank(args.tune_rank, args.cli_args)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    record: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    t0 = time.perf_counter()
    _build.load_library()
    record["build_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    if _build.build_log:  # empty when an earlier process of this checkout built the library
        (OUT_DIR / "kernels_build.log").write_text(_build.build_log)
    for line in ptxas_lines(_build.build_log):
        log(line)
    log(f"build: {record['build_s']:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rate = exp_rate()
    record["sms"], record["sm_clock_max_hz"] = rate
    record["kernels"] = [kernel_phase(s, gen, rate) for s in MAIN_SHAPES]
    record["kernels_arb"] = kernel_phase(ARB_SHAPE, gen, rate)
    for r in record["kernels"] + [record["kernels_arb"]]:
        log(f"kernels {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")

    record["optim"] = optim_phase(gen)
    for name in ("adam8_fused", "adam_bf16_fused"):
        for r in record["optim"][name]:
            log(f"optim {name} {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")
    for form in ("grouped", "grouped_xla", "grouped_int8", "grouped_fp32_grads",
                 "grouped_int8_fp32_grads"):
        for name, r in record["optim"][form].items():
            log(f"optim {form} {name}: {json.dumps(r)}")
    torch.cuda.empty_cache()

    splash_per_step = {name: CALLS_PER_STEP for name in SPLASH}
    train = train_phase(args.seed, args.steps, "adamw", splash_per_step)
    log(f"train: {train['steps_per_s']:.4f} steps/s, peak {train['peak_mem_gib']:.2f} GiB, "
        f"losses {train['losses']}, launches {train['launches']}")
    step_flops = flops.train_step_flops(UNetConfig.sd15(), 8, 64)
    peak_flops = flops.GPU_PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    train["model_flops_per_step"] = step_flops
    train["mfu"] = step_flops * train["steps_per_s"] / peak_flops if peak_flops else None
    log(f"train: model FLOPs per step {step_flops:.6e} (utils/flops.py: 3 x the UNet forward's "
        f"matmuls and convolutions, batch 8, 64^2 latents), MFU "
        + (f"{train['mfu']:.4f} at {train['steps_per_s']:.4f} steps/s against "
           f"{peak_flops:.4g} FLOP/s dense bf16" if peak_flops else
           "not computed (no dense bf16 peak known for this card)")
        + f" ({torch.cuda.get_device_name(0)}; {smi})")
    record["check"] = check_phase(train)
    log(f"check: {record['check']}")
    record["train"] = {k: v for k, v in train.items()
                       if k not in ("state", "batch", "unet_config")}
    del train
    torch.cuda.empty_cache()

    int8 = train_phase(args.seed, args.steps, "bitsandbytes.optim.AdamW8bit", splash_per_step)
    log(f"int8: {int8['steps_per_s']:.4f} steps/s, peak {int8['peak_mem_gib']:.2f} GiB, "
        f"losses {int8['losses']}, launches {int8['launches']}")
    record["train_int8"] = {k: v for k, v in int8.items()
                            if k not in ("state", "batch", "unet_config")}
    del int8
    torch.cuda.empty_cache()


    ema = ema_phase(args.seed, args.steps, splash_per_step, record["train"]["steps_per_s"])
    for name, r in ema["kernel"].items():
        log(f"ema kernel, {name} shadows over {r['leaves']} leaves: {r['ms']:.4f} ms (bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, {r['bytes'] / 1e9:.3f} GB), plain "
            f"{r['plain_ms']:.2f} ms, torch._foreach_lerp_ {r['library_ms']:.4f} ms, bit-equal "
            f"{r['bit_equal']}")
    for name in EMA_DTYPES:
        r = ema[name]
        log(f"ema {name} shadow: {r['steps_per_s']:.4f} steps/s (train phase "
            f"{ema['train_phase_steps_per_s']:.4f}), peak {r['peak_mem_gib']:.2f} GiB (train "
            f"phase {record['train']['peak_mem_gib']:.2f}), EMA {r['ema_ms_per_step']:.4f} ms "
            f"per step (device), counted launches per step {r['counted_launches_per_step']:.0f} "
            f"{r['launches_per_step']}, losses {r['losses']}")
    acc = ema["bf16"]["accumulation"]
    log(f"ema accumulation: k {acc['k']}, masters moved {acc['masters_moved']}, shadows moved "
        f"{acc['shadows_moved']} of {acc['of']}, launches {acc['launches']}")
    record["ema"] = ema
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        uncached = uncached_phase(args.seed, args.steps, Path(tmp), splash_per_step)
        log(f"uncached ({native_image.decoder_name()} decoder, {native_image.active_build} "
            f"build; {smi}): "
            f"{uncached['steps_per_s']:.4f} steps/s, peak "
            f"{uncached['peak_mem_gib']:.2f} GiB, VAE encode {uncached['vae_ms']:.3f} ms, "
            f"CLIP {uncached['clip_ms']:.3f} ms per step (device), losses "
            f"{uncached['losses']}, launches {uncached['launches']}, consistency "
            f"{uncached['consistency']}")
        decoders = decoder_leg(uncached)
        log(f"uncached decoders ({smi}): active {decoders['active']} ({decoders['build']} "
            f"build; builds here {decoders['builds']}); native "
            f"{decoders['native']}; PIL {decoders['pil']}"
            + (f"; builds tried before it: {decoders['build_error']}"
               if decoders["build_error"] else ""))
        uncached["decoders"] = decoders
        cache = cache_phase(uncached, Path(tmp), uncached["per_step"])
        log(f"cache ({cache['decoder']} decoder, {cache['decoder_build']} build; {smi}): "
            f"{cache['encoded']} images encoded in {cache['encode_s']:.3f} s "
            f"({cache['images_per_s']:.2f} images/s, decode included; device-only VAE encode "
            f"{uncached['vae_images_per_s']:.2f} images/s), {cache['file_mib']:.2f} MiB; cached "
            f"steps: losses {cache['losses']}, {cache['steps_per_s']:.4f} steps/s")
        record["uncached"] = {k: v for k, v in uncached.items()
                              if k not in ("config", "frozen", "tokenizer", "spec", "step_fn",
                                           "state")}
        record["cache"] = cache
        frozen = uncached["frozen"]
        del uncached
        gc.collect()
        torch.cuda.empty_cache()

        trainer = trainer_phase(args.seed, Path(tmp), Path(tmp) / "cache.safetensors", frozen,
                                splash_per_step, record["train"]["steps_per_s"])
        del frozen
        acc = trainer["accumulation"]
        log(f"trainer: {trainer['steady_steps_per_s']:.4f} steps/s (the trainer's own, host sync "
            f"per step; train phase {trainer['train_phase_steps_per_s']:.4f}, with a sync per "
            f"step {record['train']['synced_steps_per_s']:.4f}), first step after "
            f"{trainer['first_step_s']:.2f} s (resumed: {trainer['resume_first_step_s']:.2f} s), "
            f"checkpoint {trainer['checkpoint_gib']:.2f} GiB written in "
            f"{[round(t, 3) for _, t in trainer['save_s']]} s, read in "
            f"{[round(t, 3) for t in trainer['resume_s']]} s, peak {trainer['peak_mem_gib']:.2f} "
            f"GiB, launches per step {trainer['launches_per_step']}, losses {trainer['losses']}, "
            f"resumed {trainer['resumed_losses']} (bit-equal checkpoint)")
        log(f"trainer accumulation: k {acc['k']}, masters moved per micro-step "
            f"{acc['masters_moved']} of {acc['of']}, launches {acc['launches']}, peak "
            f"{acc['peak_mem_gib']:.2f} GiB")
        record["trainer"] = trainer
        gc.collect()
        torch.cuda.empty_cache()

        tune = tuner_phase(args.seed, Path(tmp), Path(tmp) / "model", splash_per_step)
        for t in tune["trials"]:
            log(f"tuner trial: batch {t['batch_size']}, exit {t['returncode']}, "
                f"{t['seconds']:.1f} s"
                + (f", peak {t['peak_mem_gib']:.2f} GiB, {t['steps']} steps"
                   if t["returncode"] == tuner.PROBE_OK else
                   f", the card said: {(t.get('error') or '-').splitlines()[0][:300]}"))
        log(f"tuner: {TUNER_HUB_ID} from the local HF cache, {len(tune['trials'])} trials from "
            f"batch {tune['init_batch']}, picked {tune['picked']}; {tune['steps']} steps at it: "
            f"losses {tune['losses']}, steps/s {[round(x, 4) for x in tune['steps_per_sec']]}, "
            f"peak {tune['peak_mem_gib']:.2f} GiB (this process held "
            f"{tune['parent_reserved_gib']:.2f} GiB during the trials), masters moved "
            f"{tune['masters_moved']} of {tune['of']}, launches {tune['launches']}; model FLOPs "
            f"per step {tune['model_flops_per_step']:.6e}, MFU of the last step "
            + (f"{tune['mfu_last_step']:.4f}" if tune["mfu_last_step"] is not None
               else "not computed")
            + f"; phase {tune['seconds']:.1f} s ({smi})")
        record["tuner"] = tune
        gc.collect()
        torch.cuda.empty_cache()

        world = tuner_world_phase(args.seed, Path(tmp), Path(tmp) / "model",
                                  {**splash_per_step, "adam_bf16_fused": ADAM_PER_STEP,
                                   "adam8_fused": 0, "ema_fused": 0})
        for t in world["trials"]:
            log(f"tuner world trial: batch {t['batch_size']} on {TUNER_WORLD_RANKS} ranks, "
                f"torchrun exit {t['returncode']}, {t['seconds']:.1f} s, ranks "
                + "; ".join(f"{r}: " + (f"fit, {rep.get('steps')} steps, peak "
                                        f"{rep.get('peak_mem_gib', float('nan')):.2f} GiB"
                                        if rep.get("fits") else
                                        ("OOM" if rep.get("oom") else "error") + ", "
                                        + (rep.get("error") or "-").splitlines()[0][:200])
                            for r, rep in sorted(t["ranks"].items())))
        r0 = world["ranks"][0]
        log(f"tuner world ({world['note']}; {smi}): {len(world['trials'])} trials from batch "
            f"{world['init_batch']}, picked {world['picked']} (the host's batch, "
            f"{world['picked'] // TUNER_WORLD_RANKS} rows a rank); rank 0 held a process group "
            f"during the trials {any(r0['group_during_trials'])}, a CUDA context "
            f"{any(r0['cuda_during_trials'])}; every rank trained at "
            f"{[r['batch_size'] for r in world['ranks']]} on mesh {r0['mesh']} over "
            f"{r0['backend']}: rank 0 losses {r0['losses']}, steps/s "
            f"{[round(x, 4) for x in r0['steps_per_s']]}, peak per rank "
            f"{[round(r['peak_mem_gib'], 2) for r in world['ranks']]} GiB, launches per rank "
            f"{[r['launches'] for r in world['ranks']]}; phase {world['seconds']:.1f} s")
        record["tuner_world"] = world
        gc.collect()
        torch.cuda.empty_cache()

        cd = custom_diffusion_phase(args.seed, Path(tmp), Path(tmp) / "model",
                                    Path(tmp) / "cache.safetensors")
        log(f"custom diffusion ({smi}): {cd['leaves']} K/V leaves in {cd['groups']} groups, "
            f"{cd['steps']} steps through the train CLI: losses {cd['losses']}, steps/s "
            f"{[round(x, 4) for x in cd['steps_per_s']]}, peak {cd['peak_mem_gib']:.2f} GiB, "
            f"launches {cd['launches']} (splash backward {cd['splash_bwd_per_step']} per step: "
            f"the first self-attention has no trained K/V upstream); checkpoint {cd['checkpoint_mib']:.2f} MiB; prune to "
            f"fp16: partial {cd['partial_kib']:.1f} KiB in {cd['partial_prune_s']:.2f} s, "
            f"whole {cd['full_gib']:.2f} GiB in {cd['full_prune_s']:.2f} s, reloaded in "
            f"{cd['reload_s']:.2f} s: only the K/V differ from the base ({cd['kv_moved']} "
            f"moved), each the trained weight in fp16; phase {cd['seconds']:.1f} s")
        record["custom_diffusion"] = cd

        sample = sample_phase(args.seed, Path(tmp), Path(tmp) / "model", Path(tmp) / "images")
        for name, r in sample["runs"].items():
            log(f"sample {name} ({r['method']}, {r['size'][0]}x{r['size'][1]}): "
                f"{[round(t, 3) for t in r['s_per_image']]} s per image, {r['unet_calls']} UNet "
                f"calls ({[round(n, 2) for n in r['unet_calls_per_s']]} per s), splash_fwd "
                f"{r['splash_fwd_per_image']} per image, launches {r['launches']}")
        c = sample["check"]
        log(f"sample: deterministic {sample['deterministic']}, peak {sample['peak_mem_gib']:.2f} "
            f"GiB, DDIM kernel path vs plain: first step {c['first_step_rel_err']:.3e} (bound "
            f"{CHECK_TOL}), final latents {c['final_rel_err']:.3e} relative L2 (bound "
            f"{SAMPLE_FINAL_TOL}; max-abs {c['final_rel_max_abs_err']:.3e}); "
            f"one UNet call on the CFG pair: device {c['unet_device_ms']:.3f} ms, host (issuing "
            f"included) {c['unet_host_ms']:.3f} ms, {c['unet_ops']} CUDA operations "
            f"({c['unet_ops_device_ms']:.3f} ms traced); VAE decode {c['vae_decode_ms']:.3f} ms, "
            f"CLIP (pair) {c['clip_ms']:.3f} ms (device)")
        record["sample"] = sample
        gc.collect()
        torch.cuda.empty_cache()

        lora = lora_phase(args.seed, Path(tmp), Path(tmp) / "model", Path(tmp) / "images")
        d = lora["ema_dropout"]
        log(f"lora: {lora['steps_per_s']:.4f} steps/s (resumed {lora['resumed_steps_per_s']:.4f}), "
            f"buckets {sorted({tuple(s) for s in lora['bucket_shapes']})}, trainable "
            f"{lora['trainable_params']}, {lora['groups']} groups, checkpoint "
            f"{lora['checkpoint_mib']:.2f} MiB (+ sidecar {lora['sidecar_mib']:.2f} MiB), peak "
            f"{lora['peak_mem_gib']:.2f} GiB, launches per step {lora['launches_per_step']} "
            f"({lora['splash_calls_per_step']:.1f} splash calls), losses {lora['losses']}, resumed "
            f"{lora['resumed_losses']} (bit-equal checkpoint)")
        log(f"lora dropout {d['dropout']} + bf16 EMA: {d['steps_per_s']:.4f} steps/s, peak "
            f"{d['peak_mem_gib']:.2f} GiB, launches per step {d['launches_per_step']}, losses "
            f"{d['losses']}, EMA updates {d['ema_num_updates']}")
        ls = lora["sampling"]
        log(f"lora in-training sampling: every {ls['interval_steps']} steps, "
            f"{ls['num_samples']} images, events (step, s) {ls['events_s']}, splash_fwd "
            f"{ls['splash_fwd']}")
        record["lora"] = lora
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        lp = lora_prodigy_phase(args.seed, Path(tmp), Path(tmp) / "model", Path(tmp) / "images")
        lp["seconds"] = time.perf_counter() - t0
        log(f"lora prodigy: {lp['steps_per_s']:.4f} steps/s, peak {lp['peak_mem_gib']:.2f} GiB, "
            f"launches per step {lp['launches_per_step']}, estim_lr at step {LORA_PRODIGY_SAVE} "
            f"{sorted(lp['estim_lr_at_save'].values())[:3]}..., losses {lp['losses']}, resumed "
            f"{lp['resumed_losses']} (bit-equal checkpoint); phase {lp['seconds']:.1f} s")
        record["lora_prodigy"] = lp
        gc.collect()
        torch.cuda.empty_cache()

        db = dreambooth_phase(args.seed, Path(tmp), Path(tmp) / "model", Path(tmp) / "images")
        log(f"dreambooth: {db['class_images']} class images at "
            f"{[round(t, 3) for t in db['class_s_per_image']]} s each, a second run made none; "
            f"{db['steps']} prior-preservation steps at {db['steps_per_s']:.4f} steps/s, peak "
            f"{db['peak_mem_gib']:.2f} GiB, launches {db['train_launches']}, losses "
            f"{db['losses']}")
        record["dreambooth"] = db
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        par = parallel_phase(args.seed, Path(tmp), Path(tmp) / "model",
                             Path(tmp) / "cache.safetensors")
        par["seconds"] = time.perf_counter() - t0
        record["parallel"] = par
        s1 = par["single"]
        log(f"parallel: single process {s1['steps_per_s']} steps/s, peak "
            f"{s1['peak_mem_gib']:.2f} GiB, masters + moments {s1['state_gib']:.2f} GiB, losses "
            f"{list(s1['losses'].values())} ({smi}; {par['note']})")
        c = par["cli_nccl_1"]
        log(f"parallel (a) train CLI under torch.distributed.run, {c['world']} rank, backend "
            f"{c['backend']}: {c['steps_per_s']} steps/s, peak {c['peak_mem_gib']:.2f} GiB, "
            f"losses {list(c['losses'].values())}, masters vs single {c['check']}")
        log(f"parallel: NCCL with two ranks on one card refused "
            f"{par['nccl_two_ranks_one_card']['refused']}: "
            f"{par['nccl_two_ranks_one_card']['reason']}")
        for mesh in PARALLEL_MESHES:
            for r in par["x".join(map(str, mesh))]:
                log(f"parallel (b) mesh {tuple(r['mesh'])} rank {r['rank']} ({r['backend']}): "
                    f"{[round(x, 4) for x in r['steps_per_s']]} steps/s, peak "
                    f"{r['peak_mem_gib']:.2f} GiB, masters + moments {r['state_gib']:.2f} GiB "
                    f"({r['owned']}/{r['trainable']} leaves), buckets {r['grad_buckets']} grad / "
                    f"{r['broadcast_buckets']} broadcast, losses {r['losses']}, masters vs single "
                    f"{r['check']}")
        log(f"parallel: the planted fault {par['fault']['name']} (must fail the bounds "
            f"far share <= {PARALLEL_FAR_SHARE}, delta <= {PARALLEL_DELTA_TOL}): "
            f"{par['fault']['check']}, losses {[r['losses'] for r in par['fault']['ranks']]}")
        log(f"parallel: phase {par['seconds']:.1f} s, launches {par['launches']}")
        record["kernels_parallel"] = kernel_phase(PARALLEL_TP_SHAPE, gen, rate)
        r = record["kernels_parallel"]
        log(f"kernels (parallel, tensor 2) {r['shape']}: "
            f"{json.dumps({k: r[k] for k in r if k != 'shape'})}")

        # SDXL (configs/sdxl_lora.yaml); the SD1.5 directory stays for the
        # single_file phase
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sdxl_images = write_sdxl_images(Path(tmp), args.seed)
        sdxl_model = write_sdxl_dir(Path(tmp), args.seed)
        record["sdxl_write_s"] = time.perf_counter() - t0
        gib = sum(p.stat().st_size for p in sdxl_model.rglob("*") if p.is_file()) / 2 ** 30
        log(f"sdxl: wrote SDXL-base ({gib:.2f} GiB, bf16) in {record['sdxl_write_s']:.1f} s")
        phases = {"sdxl_cache": lambda: sdxl_cache_phase(args.seed, Path(tmp), sdxl_model,
                                                         sdxl_images),
                  "sdxl_lora": lambda: sdxl_lora_phase(args.seed, Path(tmp), sdxl_model,
                                                       sdxl_images),
                  "sdxl_sample": lambda: sdxl_sample_phase(args.seed, Path(tmp), sdxl_model)}
        for name, run in phases.items():
            t0 = time.perf_counter()
            record[name] = run()
            record[name]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
        c = record["sdxl_cache"]
        log(f"sdxl cache: {c['entries']} entries with pooled embeddings in {c['encode_s']:.2f} s "
            f"({c['images_per_s']:.2f} images/s, decode included), {c['file_mib']:.2f} MiB; "
            f"{SDXL_CACHED_STEPS} cached steps at latents {c['latent_shapes']}: losses "
            f"{c['losses']}, peak {c['peak_mem_gib']:.2f} GiB, launches {c['launches']}; "
            f"phase {c['seconds']:.1f} s")
        x = record["sdxl_lora"]
        log(f"sdxl lora: {x['steps_per_s']:.4f} steps/s (resumed {x['resumed_steps_per_s']:.4f}; "
            f"steps {[round(t, 3) for t in x['step_s']]} s), first step after "
            f"{x['first_step_s']:.2f} s, buckets {sorted({tuple(s) for s in x['bucket_shapes']})}, "
            f"{x['groups']} groups, trainable {x['trainable_params']}, checkpoint "
            f"{x['checkpoint_mib']:.2f} MiB (+ sidecar {x['sidecar_mib']:.2f} MiB) written in "
            f"{[round(t, 3) for _, t in x['save_s']]} s, peak {x['peak_mem_gib']:.2f} GiB, "
            f"launches per step {x['launches_per_step']} ({x['splash_calls_per_step']:.1f} "
            f"splash calls), sampling event (step, s) {x['sampling']['events_s']} "
            f"({x['sampling']['splash_fwd']} splash_fwd), losses {x['losses']}, resumed "
            f"{x['resumed_losses']} (bit-equal checkpoint); phase {x['seconds']:.1f} s")
        log(f"sdxl lora profiled step: {json.dumps(x['profiled_step'])}")
        x = record["sdxl_sample"]
        for name, r in x["runs"].items():
            log(f"sdxl sample {name} ({r['method']}, {r['size'][0]}x{r['size'][1]}): "
                f"{r['s_per_image']:.3f} s per image, {r['unet_calls_per_s']:.2f} UNet calls per "
                f"s, splash_fwd {r['splash_fwd_per_image']} per image")
        c = x["check"]
        log(f"sdxl sample: deterministic {x['deterministic']}, peak {x['peak_mem_gib']:.2f} GiB, "
            f"DDIM kernel path vs plain: first step {c['first_step_rel_err']:.3e} (bound "
            f"{CHECK_TOL}), final latents {c['final_rel_err']:.3e} relative L2 (bound "
            f"{SAMPLE_FINAL_TOL}; max-abs {c['final_rel_max_abs_err']:.3e}); one UNet call on "
            f"the CFG pair: device {c['unet_device_ms']:.3f} ms, host {c['unet_host_ms']:.3f} ms, "
            f"{c['unet_ops']} CUDA operations ({c['unet_ops_device_ms']:.3f} ms traced); VAE "
            f"decode {c['vae_decode_ms']:.3f} ms, both towers (pair) {c['clip_ms']:.3f} ms "
            f"(device); phase {x['seconds']:.1f} s")

        # SD3 (the MMDiT): SDXL-base's directory makes room for SD3-Medium's
        shutil.rmtree(sdxl_model)
        gc.collect()
        torch.cuda.empty_cache()
        sd3_phases(record, args, gen, rate, Path(tmp))
        # single-file checkpoints: SD3-Medium's directory makes room for
        # SD2.1's files
        shutil.rmtree(Path(tmp) / "sd3")
        gc.collect()
        torch.cuda.empty_cache()
        single_file_phase(record, args, gen, rate, Path(tmp))

    # the kernels in the forms and at the shapes the lora phase ran them
    record["kernels_lora"] = [kernel_phase(tuple(sh), gen, rate) for sh in lora["splash_shapes"]]
    for r in record["kernels_lora"]:
        log(f"kernels (lora) {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")
    # splash_fwd in the forms sampling runs it
    record["kernels_sampling"] = [sampling_kernel_case(sh, gen, rate) for sh in SAMPLING_SHAPES]
    for r in record["kernels_sampling"]:
        log(f"kernels (sampling, inference) {r['shape']}: splash_fwd {r['ms']:.4f} ms (bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}), plain {r['plain_ms']:.3f} ms, SDPA "
            f"forward {r['sdpa_fwd_ms']:.4f} ms, max-abs err {r['err']:.3e}")
    record["lora_kernels"] = lora_kernel_case(gen)
    lk = record["lora_kernels"]
    a = lk["adam_bf16_fused"]
    log(f"lora kernels ({smi}): adam_bf16_fused over {lk['groups']} groups ({lk['leaves']} fp32 "
        f"leaves, {lk['elements']} elements, {a['chunks']} CTAs): {a['launches']} launch per "
        f"step, device {a['ms']:.4f} ms, call {a['call_ms']:.4f} ms, optimizer step host "
        f"{a['host_ms']:.3f} ms (bound {a['bound'][0]:.4f} ms by {a['bound'][1]}), plain "
        f"{a['plain_ms']:.2f} ms, torch._fused_adamw_ {a['library_ms']:.4f} ms, bit-equal "
        f"{a['err']}")
    for name, r in lk["ema_fused"].items():
        log(f"lora kernels ({smi}): ema_fused, {name} shadows over the {r['leaves']} factors of "
            f"{r['groups']} UNet groups (fp32 masters): {r['launches']} launch per step, device "
            f"{r['ms']:.4f} ms, call {r['call_ms']:.4f} ms (bound {r['bound'][0]:.4f} ms by "
            f"{r['bound'][1]}), plain {r['plain_ms']:.2f} ms, torch._foreach_lerp_ "
            f"{r['library_ms']:.4f} ms, bit-equal {r['bit_equal']}")
    torch.cuda.empty_cache()
    # the kernels in SDXL's forms: head dim 64 (DP = 64), the lora run's buckets
    sdxl_shapes = sorted({tuple(sh) for sh in SDXL_KERNEL_SHAPES}
                         | {tuple(sh) for sh in record["sdxl_lora"]["splash_shapes"]})
    record["kernels_sdxl"] = [kernel_phase(sh, gen, rate) for sh in sdxl_shapes]
    for r in record["kernels_sdxl"]:
        log(f"kernels (sdxl) {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")
    record["kernels_sdxl_sampling"] = [sampling_kernel_case(sh, gen, rate)
                                       for sh in SDXL_SAMPLING_SHAPES]
    for r in record["kernels_sdxl_sampling"]:
        log(f"kernels (sdxl sampling, inference) {r['shape']}: splash_fwd {r['ms']:.4f} ms (bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}), plain {r['plain_ms']:.3f} ms, SDPA "
            f"forward {r['sdpa_fwd_ms']:.4f} ms, max-abs err {r['err']:.3e}")
    record["sdxl_kernels"] = sdxl_kernel_case(gen)
    sk = record["sdxl_kernels"]
    a = sk["adam_bf16_fused"]
    log(f"sdxl kernels ({smi}): adam_bf16_fused over {sk['groups']} groups "
        f"{sk['groups_by_component']} ({sk['leaves']} fp32 leaves, {sk['elements']} elements, "
        f"{a['chunks']} CTAs): {a['launches']} launch per step, device {a['ms']:.4f} ms, call "
        f"{a['call_ms']:.4f} ms, optimizer step host {a['host_ms']:.3f} ms (bound "
        f"{a['bound'][0]:.4f} ms by {a['bound'][1]}), plain {a['plain_ms']:.2f} ms, "
        f"torch._fused_adamw_ {a['library_ms']:.4f} ms, bit-equal {a['err']}")
    torch.cuda.empty_cache()

    # last: its torch.profiler traces of ~20,000 launches come after every
    # kernel_device_ms trace of the other phases
    t0 = time.perf_counter()
    families = families_phase(args.seed, FAMILY_STEPS, splash_per_step, warmup=FAMILY_STEPS)
    families["seconds"] = time.perf_counter() - t0
    ref = families["families"]["adamw"]["optimizer"]
    for name, r in families["families"].items():
        o = r["optimizer"]
        log(f"family {name}: {r['steps_per_s']:.4f} steps/s, optimizer {o['device_ms']} ms "
            f"device / {o['host_ms']:.2f} ms host per step (AdamW {ref['device_ms']} / "
            f"{ref['host_ms']:.2f}), {o['launches']} CUDA launches per optimizer step (traces "
            f"{o['traced_launches']}), "
            f"peak {r['peak_mem_gib']:.2f} GiB, {r['param_groups']} groups, launches "
            f"{r['launches']}, losses {r['losses']}, first update card vs CPU "
            f"{r['first_update']['rel_err']} (bound {r['first_update']['tol']})"
            + (f", estim_lr {r['estim_lr']} after {r['extra_steps_to_move_estim_lr']} more "
               f"steps" if "estim_lr" in r else ""))
    log(f"families: phase {families['seconds']:.1f} s")
    record["families"] = families
    gc.collect()
    torch.cuda.empty_cache()

    kernels = kernel_entries(record)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
