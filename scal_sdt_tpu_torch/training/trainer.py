"""The training loop (port of ``scal_sdt_tpu/training/trainer.py``).

``Trainer`` owns a run: it loads the models, resolves the tokenizer, installs
custom embeddings, resolves the optim target, injects LoRA factors (with
their dropout rates) and textual-inversion rows, splits the parameters into
trainable masters (fp32, or bf16 under ``optimizer.master_dtype: bf16``) and
frozen weights (bf16 under bf16 compute unless ``trainer.frozen_dtype:
fp32``) on its device, builds the data pipeline, the per-group optimizer
(with gradient accumulation; textual inversion in its own ``ti`` group) and
the train step (with the EMA), and runs the epoch loop with logging,
checkpoints, mid-epoch resume, the NaN tripwire, the SIGTERM autosave, the
profiler and the in-training sample callback (``training/sample_callback.py``,
fed by ``merged_inference_params``). An SDXL or SD3 model's second text
tower is a third component (``condition_model.encoder_2``), frozen unless
the optim target's ``text_encoder_2`` section addresses it; an SDXL or SD3
run from a cache needs its pooled embeddings (``{id}.pooled``). An SD3
model's denoiser is its MMDiT, under the ``unet`` prefix, and its T5 tower
(``condition_model.encoder_3``) is always frozen, as in the JAX package;
live text encoding with T5 needs ``tokenizer_3/tokenizer.json`` (or the
``tokenizer_3:`` key), which the pipeline runs beside the CLIP tokenizer.

Under ``python -m torch.distributed.run`` each process trains on its card
in the (data, fsdp, tensor) mesh of ``trainer.mesh`` (``parallel/mesh.py``;
``data: null`` takes the world). ``batch_size`` is per host, as in the JAX
package, where one process per host runs the sampler: here every rank runs
its host's sampler (world = hosts, rank = host index) and decodes its own
rows of each host batch, split over the host's data x fsdp ranks and shared
by tensor peers (``parallel/sharding.py``). The gradients are averaged over
the data-parallel ranks, every trainable leaf has one owner among the fsdp x
tensor ranks (its master, optimizer state and EMA shadow live there alone),
the denoiser's transformer linears split over the tensor ranks
(``parallel/tensor.py``), and logging, sampling and writes run on rank 0;
checkpoints and the SIGTERM autosave are collective.
The trainer keys of the JAX package that steer XLA (compile caches, bucket
warm-up, buffer donation) are accepted and do nothing in eager PyTorch; the
trainer says so once. Its packing keys (``param_packing``, ``pack_min_size``,
``pack_stacks``) pack nothing here either, but the trainer builds the spec
they imply (``training/packing.py``): Adafactor treats its slabs and stacks
as blocks, as the JAX package's numbers depend on them, and a JAX run's
optimizer state is unpacked by it on ``--resume``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import signal
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..conf import Config, load_optim_target
from ..data.datasets import LatentCache
from ..data.pipeline import DataPipeline, get_dataset, get_sampler, to_device
from ..device import resolve_device
from ..models.functional import set_lora_dropout_rates
from ..ops import attention as attention_ops
from ..text.embeddings import TOKEN_EMBEDDING_KEY, install_custom_embeddings, load_embeddings_dir
from ..text.ti import TRAINED_EXTRA_KEY, parse_ti_specs, setup_ti_training
from ..text.tokenizer import resolve_t5_tokenizer, resolve_tokenizer
from ..parallel.mesh import (LaunchEnv, check_mesh, init_process_group, mesh_from_config,
                             process_device, tp_param_names)
from ..parallel.sharding import Parallel, Rows
from ..parallel.tensor import TensorParallel, all_reduce_sum, split_layers, tensor_sum_keys
from ..utils import tracing
from ..utils.logging import is_main_process, main_process_logger
from .checkpoint import CheckpointManager, load_loop_state, restore_train_state
from .families import GroupOwners
from .lora import init_lora_params
from .optim_targets import COMPONENT_PREFIX, group_labels, resolve_optim_target
from .optimizers import build_optimizer
from .packing import DEFAULT_MIN_SLAB_SIZE, PackSpec, build_pack_spec
from .step import (TE2_PREFIX, TE3_PREFIX, TE_PREFIX, UNET_PREFIX, VAE_PREFIX, Draws,
                   StepSpec, init_train_state, make_train_step)

logger = main_process_logger("trainer")

# trainer keys of the JAX package with nothing to steer in eager PyTorch
INERT_TRAINER_KEYS = ("compilation_cache", "compilation_cache_dir", "aot_bucket_warmup",
                      "donate_state")
# the JAX trainer's packing: here Adafactor's blocks, AdamW8bit's int8 leaves and a
# JAX resume
PACKING_KEYS = ("param_packing", "pack_min_size", "pack_stacks")
_BF16_NAMES = ("16", "bf16", "bfloat16")


def jax_pack_spec(config: Config, shapes: dict, labels: dict,
                  tensor: int = 1) -> Optional[PackSpec]:
    """The slabs and stacks the JAX trainer packs the trainables into under
    this config (None with ``trainer.param_packing: false`` or nothing to
    pack): fp32 leaves under ``pack_min_size`` elements per (component,
    group), and with ``pack_stacks`` the big ones of one shape; the weights
    a ``tensor`` axis shards stay out, as in JAX. ``shapes``: the trainables
    before a bf16 master cast, as the JAX trainer packs them."""
    if not bool(config.trainer.get("param_packing", True)):
        return None
    spec = build_pack_spec(shapes, labels,
                           min_slab_size=int(config.trainer.get("pack_min_size")
                                             or DEFAULT_MIN_SLAB_SIZE),
                           stack_big=bool(config.trainer.get("pack_stacks", False)),
                           exclude=tp_param_names(shapes, tensor))
    return spec if spec.nontrivial else None


def global_rows(lo: int, hi: int, batch_size: int, hosts: int, host: int,
                prior: bool) -> Rows:
    """The rank's rows [lo, hi) of its host's batch as positions in the
    global batch (hosts' batches in host order; with prior preservation each
    host batch is its instance rows, then its class rows)."""
    per_host = batch_size * (2 if prior else 1)
    own = torch.arange(lo, hi)
    index = torch.cat([own, own + batch_size]) if prior else own
    return Rows(index=index + host * per_host, total=per_host * hosts)


def _prefixed(params: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}": v for k, v in params.items()}


class Trainer:
    def __init__(self, config: Config, run_dir: Path, models=None, tokenizer=None,
                 device="cuda", backend: Optional[str] = None):
        """``models``: optional pre-loaded ``LoadedModels`` (the CLI loads
        ``config.model``); ``device``: where the run trains (a card unless
        the caller asks for the CPU; ``cuda`` is ``cuda:LOCAL_RANK`` under
        torchrun); ``backend``: the process group's, over the device's
        default (NCCL on cards, gloo on the CPU)."""
        self.config = config
        self.run_dir = Path(run_dir)
        env = LaunchEnv.from_environ()
        self.device = resolve_device(process_device(device, env))
        check_mesh(config.trainer, env, config.batch_size)
        init_process_group(self.device, backend, env)
        self.mesh = mesh_from_config(config.trainer, env)
        if self.mesh.world > 1:
            logger.info(f"mesh (data, fsdp, tensor) = {self.mesh.shape} over "
                        f"{self.mesh.world} ranks, backend {self.mesh.backend}")
        inert = [k for k in INERT_TRAINER_KEYS if k in config.trainer]
        if inert:
            logger.info(f"trainer keys {inert} steer XLA in the JAX package; they do nothing "
                        "here")
        packing = [k for k in PACKING_KEYS if k in config.trainer]
        if packing:
            logger.info(f"trainer keys {packing} pack no parameters here; they steer "
                        "Adafactor's blocks, AdamW8bit's int8 leaves and the reading of a "
                        "JAX run's optimizer state (slabs and stacks unpacked per leaf)")

        # the reference's seed_everything: data-path randomness is seeded per
        # item, stray global draws get determinism too
        seed = int(config.get("seed") or 0)
        random.seed(seed)
        np.random.seed(seed % (2 ** 32 - 1))

        if models is None:
            from ..convert.loader import load_components

            models = load_components(config)
        self.models = models
        # cache-backed runs never consume prompt ids: the hash stand-in is harmless
        self.tokenizer = (tokenizer if tokenizer is not None
                          else resolve_tokenizer(config, allow_hash=bool(config.data.get("cache"))))

        # `xformers: false` in the reference turns memory-efficient attention
        # off; here it keeps every call off the splash kernels
        attention_ops.FORCE_MATH = not bool(config.get("xformers", True))

        # -- custom embeddings: extra frozen rows of the token table ------------
        models = dataclasses.replace(models, clip=dict(models.clip))
        embeddings = config.get("custom_embeddings") or {}
        if embeddings.get("enabled", False):
            embs = load_embeddings_dir(embeddings.path)
            logger.info(f"Loaded {len(embs)} custom embeddings")
            models.clip = install_custom_embeddings(models.clip, self.tokenizer, embs)
            models.clip_config = dataclasses.replace(
                models.clip_config, vocab_size=models.clip[TOKEN_EMBEDDING_KEY].shape[0])
        self.models = models

        self.resolutions = resolve_optim_target(
            load_optim_target(config.optim_target), models.unet.keys(), models.clip.keys(),
            text_encoder_2_keys=models.clip2.keys() if models.clip2 is not None else None)
        self.train_text_encoder = bool(self.resolutions["text_encoder"].trainable)

        # -- LoRA factors, drawn path by path from one CPU generator ---------------
        seed_gen = torch.Generator().manual_seed(seed)
        components = {"unet": dict(models.unet), "text_encoder": models.clip}
        if models.clip2 is not None:
            # SDXL's and SD3's tower 2 trains through the same optim-target
            # engine (section `text_encoder_2:`); frozen when unaddressed
            components["text_encoder_2"] = dict(models.clip2)
        for comp, res in self.resolutions.items():
            if res.lora:
                components[comp].update(init_lora_params(seed_gen, components[comp], res.lora))
                logger.info(f"Injected {len(res.lora)} LoRA modules into {comp}")
        dropout = {path: spec.dropout for res in self.resolutions.values()
                   for path, spec in res.lora.items() if spec.dropout}
        set_lora_dropout_rates(dropout)
        if dropout:
            logger.info(f"LoRA dropout active on {len(dropout)} modules")

        # -- textual-inversion training: its own trainable rows ---------------------
        self.ti_meta = None
        ti_conf = embeddings.get("train") or {}
        if ti_conf.get("enabled", False):
            if config.data.get("cache"):
                raise ValueError("custom_embeddings.train requires live text encoding; it "
                                 "cannot train from a precomputed condition cache")
            components["text_encoder"], self.ti_meta = setup_ti_training(
                components["text_encoder"], self.tokenizer, parse_ti_specs(ti_conf), seed=seed)

        # -- trainable / frozen partition, on the device -----------------------
        trainable_keys = {f"{COMPONENT_PREFIX[comp]}.{k}"
                          for comp, res in self.resolutions.items() for k in res.trainable}
        if self.ti_meta:
            trainable_keys.add(f"{TE_PREFIX}.{TRAINED_EXTRA_KEY}")
        master_bf16 = str(config.optimizer.get("master_dtype", "fp32")) in ("bf16", "bfloat16")
        compute_bf16 = str(config.trainer.get("precision", "bf16")) in _BF16_NAMES
        # frozen weights are cast to the compute dtype at every use, so bf16
        # storage under bf16 compute gives the same numbers at half the memory
        dtypes = {True: torch.bfloat16 if master_bf16 else torch.float32,
                  False: torch.bfloat16 if compute_bf16 and str(
                      config.trainer.get("frozen_dtype", "compute")) != "fp32"
                  else torch.float32}
        if (models.is_sdxl or models.is_sd3) and config.data.get("cache"):
            # the pooled embedding feeds SDXL's text_time conditioning and the
            # MMDiT's adaLN: a cache built against an SD1.x model cannot feed
            # these models
            probe = LatentCache(config.data.cache)
            first = probe.entries[0] if probe.entries else None
            if (first is not None and probe.cond(int(first)) is not None
                    and probe.pooled(int(first)) is None):
                raise ValueError("SDXL/SD3 training needs a cache with pooled embeddings "
                                 "({id}.pooled): rebuild it with cli.cache against this model")
        trainable: dict = {}
        frozen: dict = {}
        jax_shapes: dict = {}   # the trainables as the JAX trainer packs them
        params = {**_prefixed(components["unet"], UNET_PREFIX),
                  **_prefixed(components["text_encoder"], TE_PREFIX),
                  **_prefixed(models.vae, VAE_PREFIX)}
        if models.clip2 is not None:
            params.update(_prefixed(components["text_encoder_2"], TE2_PREFIX))
        if models.t5 is not None:
            # SD3's T5 conditions only: frozen, as the published SD3
            # fine-tuning recipes and the JAX trainer keep it
            params.update(_prefixed(models.t5, TE3_PREFIX))
        for k, v in params.items():
            is_trainable = k in trainable_keys
            if is_trainable:
                jax_shapes[k] = v
            dtype = dtypes[is_trainable] if v.is_floating_point() else v.dtype
            # a copy: the masters change in place, the loaded models stay
            (trainable if is_trainable else frozen)[k] = v.to(self.device, dtype, copy=True)
        if not trainable:
            raise ValueError("Optim target selects no trainable parameters")
        logger.info(f"Trainable tensors: {len(trainable)}, frozen: {len(frozen)}")
        self.frozen = frozen

        # -- data: the host's sampler, the rank's rows of each host batch -----------
        dataset = get_dataset(config, use_cache=True)
        sampler = get_sampler(dataset, config, env.hosts, env.host)
        rows = None
        if self.mesh.world > 1:
            lo, hi = self.mesh.host_rows(int(config.batch_size))
            rows = global_rows(lo, hi, int(config.batch_size), env.hosts, env.host,
                               bool(config.prior_preservation.get("enabled", False)))
        num_workers = config.get("num_workers")
        # SD3 with T5: the third tokenizer for live text encoding; a run from
        # a condition cache never tokenizes
        tokenizer_3 = None
        if models.t5 is not None:
            tokenizer_3 = resolve_t5_tokenizer(config)
            if tokenizer_3 is None and not config.data.get("cache"):
                raise ValueError(
                    "SD3 model has a T5 tower (text_encoder_3) but no tokenizer_3/tokenizer.json "
                    "was found: provide one (config key `tokenizer_3:`), train from a "
                    "condition cache, or drop the T5 tower from the model directory")
        self.pipeline = DataPipeline(dataset, sampler, config.batch_size, self.tokenizer,
                                     num_workers=num_workers if num_workers is not None else 4,
                                     tokenizer_3=tokenizer_3,
                                     rows=(lo, hi) if rows is not None else None)
        self.steps_per_epoch = max(len(self.pipeline), 1)

        # -- optimizer and step ----------------------------------------------------
        labels = group_labels(self.resolutions)
        groups = [group for res in self.resolutions.values() for group in res.groups]
        overrides = {f"g{i}": group.optimizer for i, group in enumerate(groups)}
        if self.ti_meta:
            # its own group: a much higher lr than fine-tuning, no weight decay
            labels[f"{TE_PREFIX}.{TRAINED_EXTRA_KEY}"] = "ti"
            overrides["ti"] = {"lr": float(ti_conf.get("lr", 5e-3)), "weight_decay": 0.0}
        self.pack_spec = jax_pack_spec(config, jax_shapes, labels, self.mesh.tensor)
        del jax_shapes

        # -- the mesh: owners of the masters, tensor-split layers -------------------
        self.parallel = None
        compute = None
        if self.mesh.world > 1:
            tp = None
            tensor_sum: set = set()
            if self.mesh.tensor > 1:
                denoiser = {k[len(UNET_PREFIX) + 1:]: tuple(v.shape)
                            for k, v in {**trainable, **frozen}.items()
                            if k.startswith(UNET_PREFIX + ".")}
                layers = split_layers(denoiser, self.mesh.tensor)
                tp = TensorParallel(self.mesh.tensor, self.mesh.tensor_index,
                                    self.mesh.group("tensor"), layers)
                tensor_sum = tensor_sum_keys(layers, trainable, UNET_PREFIX)
            units = ([[s.key for s in slots] for _, _, slots in self.pack_spec.slabs]
                     + [list(members) for _, members, _ in self.pack_spec.stacks]
                     if self.pack_spec is not None else [])
            self.parallel = Parallel(self.mesh, {k: (tuple(v.shape), v.dtype)
                                                 for k, v in trainable.items()},
                                     rows=rows, tp=tp, tensor_sum=tensor_sum, units=units)
            if self.parallel.sharded:
                # the step's gradient dtype: the compute dtype (bf16), or the
                # masters' own under fp32 compute, as loss_and_grads takes it
                grad_dtype = torch.float32 if str(config.trainer.get("precision", "bf16")) \
                    == "32" else torch.bfloat16
                grad_dtype = dtypes[True] if grad_dtype == torch.float32 else grad_dtype
                compute = {k: v.to(grad_dtype, copy=True) for k, v in trainable.items()}
                trainable = self.parallel.owned(trainable)
                labels = {k: v for k, v in labels.items() if k in trainable}
                n_owned = len(trainable)
                logger.info(f"rank {self.mesh.rank} owns {n_owned}/{len(compute)} trainable "
                            "leaves")
        owners = None
        if self.parallel is not None and self.parallel.sharded:
            # Prodigy's and D-Adapt's group-wide sums run over the owners;
            # under accumulation their gradients are the fp32 means
            accumulate = int(config.trainer.get("accumulate_grad_batches", 1) or 1)
            owners = GroupOwners(self._group_sum, (torch.float32 if accumulate > 1
                                                   else grad_dtype, dtypes[True]))
        self.tx, self.lr_fn = build_optimizer(config, labels, overrides, self.steps_per_epoch,
                                              env.hosts, pack_spec=self.pack_spec,
                                              owners=owners)
        self.spec = StepSpec.from_config(config, models.unet_config, models.schedule,
                                         vae_config=models.vae_config,
                                         clip_config=models.clip_config,
                                         train_text_encoder=self.train_text_encoder,
                                         clip2_config=models.clip2_config,
                                         mmdit_config=models.mmdit_config,
                                         t5_config=(models.t5_config if models.t5 is not None
                                                    else None))
        ema = config.get("ema") or {}
        ema_enabled = bool(ema.get("enabled", False))
        self.train_step = make_train_step(self.spec, self.tx, self.lr_fn, ema_enabled,
                                          parallel=self.parallel)
        self.state = init_train_state(
            trainable, self.tx, seed=seed, ema_enabled=ema_enabled,
            ema_decay=float(ema.get("decay", 0.995)),
            ema_dtype=(torch.bfloat16 if str(ema.get("dtype", "fp32")) in ("bf16", "bfloat16")
                       else torch.float32),
            compute=compute, device=self.device)
        del trainable, compute

        self.ckpt = CheckpointManager(self.run_dir, config.checkpoint, self.parallel)
        self._writers = self._build_loggers()
        self.global_step = 0
        # the epoch cursor of a mid-epoch resume: {epoch, batch_in_epoch} ride
        # in the checkpoint, and the pipeline skips the consumed batches
        self.epoch_cursor = 0
        self.batch_in_epoch = 0

    def _group_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-dim fp32 ``x`` summed over the model group (the owners)."""
        total = x.detach().float().to(self.device).clone()
        all_reduce_sum(total, self.mesh.group("model"))
        return total.to(x.device)

    # ------------------------------------------------------------------ io

    def _build_loggers(self) -> list:
        writers = []
        loggers_conf = self.config.get("loggers", {}) or {}
        if is_main_process() and loggers_conf.get("tensorboard") is not None:
            try:
                from tensorboardX import SummaryWriter

                writers.append(("tb", SummaryWriter(str(self.run_dir / "tb"))))
            except ImportError:
                logger.warning("tensorboardX unavailable; tensorboard logging off")
        if is_main_process() and loggers_conf.get("wandb") is not None:
            try:
                import wandb

                wandb.init(project=self.config.project, dir=str(self.run_dir))
                writers.append(("wandb", wandb))
            except ImportError:
                logger.warning("wandb unavailable; wandb logging off")
        return writers

    def _log(self, metrics: dict, step: int) -> None:
        for kind, w in self._writers:
            if kind == "tb":
                for k, v in metrics.items():
                    w.add_scalar(k, float(v), step)
            else:
                w.log(metrics, step=step)

    # ---------------------------------------------------------------- loop

    def resume(self, ckpt_path: Path) -> None:
        """Every rank restores its own leaves (and its EMA shadows and
        optimizer state) from the checkpoint; owners then broadcast their
        compute copies."""
        self.state = restore_train_state(Path(ckpt_path), self.state, pack_spec=self.pack_spec)
        if self.state.compute is not None:
            self.parallel.refresh_compute(self.state.compute, self.state.trainable)
        self.global_step = int(self.state.step)
        loop = load_loop_state(Path(ckpt_path))
        if loop.get("epoch") is not None:
            self.epoch_cursor = int(loop["epoch"])
            self.batch_in_epoch = int(loop.get("batch_in_epoch") or 0)
        else:  # a checkpoint without loop state: the epoch boundary before it
            self.epoch_cursor = self.global_step // max(self.steps_per_epoch, 1)
            self.batch_in_epoch = 0
        logger.info(f"Resumed at step {self.global_step} "
                    f"(epoch {self.epoch_cursor}, batch {self.batch_in_epoch})")

    def _device_batch(self, batch: dict) -> dict:
        return to_device({k: v for k, v in batch.items() if k not in ("ids", "prompts")},
                         self.device)

    def fit(self, sample_callback=None, max_steps_override: Optional[int] = None,
            final_save: bool = True,
            draws_fn: Optional[Callable[[int], Draws]] = None) -> dict:
        """Train until ``trainer.max_epochs`` or ``trainer.max_steps`` (or
        ``max_steps_override``); returns the last logged metrics.
        ``draws_fn(step)`` replaces the step's draws from the generator
        (tests feed the JAX package's through it). A SIGTERM saves a
        checkpoint after the step in flight and returns."""
        preempted = {"flag": False}

        def _on_sigterm(signum, frame):
            preempted["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:  # not in the main thread
            prev_handler = None
        try:
            return self._run(sample_callback, max_steps_override, final_save, draws_fn,
                             preempted)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _run(self, sample_callback, max_steps_override, final_save, draws_fn,
             preempted: dict) -> dict:
        cfg_t = self.config.trainer
        max_epochs = int(cfg_t.get("max_epochs", 1) or 1)
        max_steps = (max_steps_override if max_steps_override is not None
                     else int(cfg_t.get("max_steps", -1) or -1))
        log_every = int(cfg_t.get("log_every_n_steps", 1) or 1)
        profiler = _StepProfiler(self.config.get("profiler") or {}, self.run_dir, self.device)

        # SSDT_STEP_TIMINGS=<path>: one JSON line per logged step {step, shape,
        # dt}, the shape in the JAX package's (B, H, W, C) order
        timings_path = os.environ.get("SSDT_STEP_TIMINGS")
        if timings_path and is_main_process():
            Path(timings_path).write_text("")

        epoch = self.epoch_cursor
        last_metrics: dict = {}
        t0 = time.perf_counter()
        try:
            while epoch < max_epochs:
                self.epoch_cursor = epoch
                # mid-epoch resume: replay the epoch and skip the batches the
                # checkpointed run consumed
                self.pipeline.set_epoch(epoch, skip_batches=self.batch_in_epoch)
                batches = iter(self.pipeline)
                while True:
                    profiler.before_step(self.global_step)
                    with tracing.span("trainer.batch"):
                        batch = next(batches, None)
                        dev_batch = None if batch is None else self._device_batch(batch)
                    if batch is None:
                        break
                    draws = draws_fn(self.global_step) if draws_fn is not None else None
                    self.state, metrics = self.train_step(self.state, self.frozen, dev_batch,
                                                          draws)
                    self.global_step += 1
                    self.batch_in_epoch += 1

                    if self.global_step % log_every == 0:
                        with tracing.span("trainer.log"):
                            # float() of the loss waits for the step: the timing barrier
                            host = {k: float(v) for k, v in metrics.items()}
                            dt = time.perf_counter() - t0
                            t0 = time.perf_counter()
                            host["steps_per_sec"] = 1.0 / max(dt, 1e-9)
                            last_metrics = host
                            if timings_path and is_main_process():
                                s = next((tuple(v.shape) for k, v in dev_batch.items()
                                          if k in ("images", "latents")), None)
                                with open(timings_path, "a") as f:
                                    f.write(json.dumps({
                                        "step": self.global_step,
                                        "shape": s and (s[0], s[2], s[3], s[1]),
                                        "dt": round(dt, 5)}) + "\n")
                            self._log(host, self.global_step)
                            if self.global_step % max(log_every * 10, 10) == 0:
                                logger.info(f"step {self.global_step}: "
                                            f"loss={host.get('train_loss', float('nan')):.4f} "
                                            f"lr={host.get('lr', 0):.2e} "
                                            f"{host.get('steps_per_sec', 0):.2f} steps/s")
                            if not np.isfinite(host.get("train_loss", 0.0)):
                                raise FloatingPointError(f"NaN loss at step {self.global_step}")

                    if sample_callback is not None:
                        with tracing.span("trainer.sample"):
                            sample_callback(self, self.global_step)

                    if self._any_rank(preempted["flag"]):
                        logger.warning(f"SIGTERM received: autosaving at step "
                                       f"{self.global_step}")
                        self._save(epoch, last_metrics)
                        return last_metrics

                    if (self.ckpt.every_n_train_steps
                            and self.global_step % int(self.ckpt.every_n_train_steps) == 0):
                        self._save(epoch, last_metrics)
                    profiler.after_step(self.global_step)

                    if 0 < max_steps <= self.global_step:
                        if final_save:
                            self._save(epoch, last_metrics)
                        return last_metrics

                epoch += 1
                self.batch_in_epoch = 0
                self.epoch_cursor = epoch
                if self.ckpt.every_n_epochs and epoch % int(self.ckpt.every_n_epochs) == 0:
                    self._save(epoch, last_metrics)
            return last_metrics
        finally:
            profiler.close()

    def _any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (the collective autosave needs
        every rank to agree)."""
        group = self.mesh.group("cpu")
        if group is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    def _save(self, epoch: int, metrics: dict) -> None:
        with tracing.span("trainer.save"):
            self.ckpt.save(self.state, self.frozen, {"epoch": epoch, "step": self.global_step,
                                                     **metrics},
                           loop_state={"epoch": epoch, "batch_in_epoch": self.batch_in_epoch},
                           extra_meta={"ti_tokens": self.ti_meta} if self.ti_meta else None)

    def natural_trainable(self) -> dict:
        """The trainable masters under their natural names (the port packs
        no leaves into slabs, so this is the state's own dict; under sharded
        masters, the rank's own)."""
        return dict(self.state.trainable)

    def merged_inference_params(self) -> dict:
        """The current frozen + trainable view for sampling (LoRA factors stay
        run-time deltas, which the UNet forward consumes); under sharded
        masters the trainables' compute copies, which every rank holds."""
        trainable = self.state.compute if self.state.compute is not None else \
            self.state.trainable
        return {**self.frozen, **trainable}


class _StepProfiler:
    """The config's ``profiler: {enabled, start_step, num_steps, dir}``: a
    ``torch.profiler`` trace of steps [start_step, start_step + num_steps),
    written as a Chrome trace under ``dir`` (default ``<run_dir>/profile``).
    The port's spans (``utils/tracing.py``) are on for those steps, so the
    trace carries them."""

    def __init__(self, conf: dict, run_dir: Path, device: torch.device):
        self.enabled = bool(conf.get("enabled", False)) and is_main_process()
        self.start = int(conf.get("start_step", 10))
        self.steps = int(conf.get("num_steps", 5))
        self.dir = Path(conf.get("dir") or (run_dir / "profile"))
        self.device = device
        self._prof = None
        self._spans = contextlib.ExitStack()

    def before_step(self, step: int) -> None:
        if self.enabled and self._prof is None and step == self.start:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._spans.enter_context(tracing.on())

    def after_step(self, step: int) -> None:
        if self._prof is not None and step >= self.start + self.steps:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._spans.close()
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"trace_step{self.start}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        self.enabled = False
        logger.info(f"Wrote profiler trace to {path}")
