"""Checkpoint save/load and retention (port of ``scal_sdt_tpu/training/checkpoint.py``).

Two files per checkpoint:

* ``<name>.safetensors``: the file both packages read and write, with the same
  keys, dtypes and metadata. Trainable tensors under their natural names
  (``unet.*``, ``condition_model.encoder.*``, SDXL's
  ``condition_model.encoder_2.*``) in the masters' dtype, stored
  LoRA alphas from the frozen dict, the EMA shadow (when EMA is on) under
  ``unet_ema.shadow_params.*`` in the shadow's dtype, and metadata
  ``{"json": {"step", "ema_decay", "ema_num_updates", "epoch",
  "batch_in_epoch", "ti_tokens", ...}}``.
* ``<name>.safetensors.torchstate``: the port's exact-resume sidecar, itself
  a safetensors file: the optimizer state (per group: Adam's moments,
  Adam8bit's payloads and scales, Lion's momentum, Adafactor's statistics,
  Prodigy's and D-Adapt's moments and 0-dim scalars, plus the accumulation
  sum under gradient accumulation) under dotted paths, the generator's state
  as a uint8 tensor, and the step counts in the JSON metadata. Only tensors
  and plain ints, no pickled objects. The JAX package's sidecar is
  ``.trainstate`` (flax msgpack of its optimizer state, step and PRNG key):
  from a JAX checkpoint without the port's sidecar the port reads it
  (``utils/msgpack.py``), unpacks slab moments with the JAX run's pack spec
  and maps each family's optax state onto its own (``convert/from_jax.py``);
  the JAX PRNG key does not carry over (the port draws from a
  ``torch.Generator``, difference (b)).

Restores copy into the template state's tensors in place (the EMA shadow
too), so the optimizer's and the EMA's cached leaf tables stay valid after
a resume.

Under sharded masters (``parallel/sharding.py``) saving is collective: every
rank's own masters, optimizer state and EMA shadows are gathered on rank 0,
which writes the single-process layout (for the same state, the same files
tensor for tensor). A restore needs nothing of the kind: every rank reads
the files and keeps the leaves its template state holds.

Retention mirrors the reference's ModelCheckpoint knobs: every_n_epochs /
every_n_train_steps / save_top_k / monitor / mode, with ``{epoch}`` /
``{step}`` / metric templating in file names.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Optional

import torch

from ..utils.logging import is_main_process, main_process_logger
from ..utils.msgpack import read_flax_state
from ..utils.state import load_metadata, load_state_dict, save_state_dict
from .packing import PackSpec
from .step import UNET_PREFIX, TrainState

logger = main_process_logger("checkpoint")

EMA_PREFIX = "unet_ema.shadow_params."
SIDECAR_SUFFIX = ".torchstate"      # the port's exact-resume file
JAX_SIDECAR_SUFFIX = ".trainstate"  # the JAX package's
GENERATOR_KEY = "generator"


def sidecar_path(path: Path) -> Path:
    return Path(str(path) + SIDECAR_SUFFIX)


def checkpoint_state_dict(state: TrainState, frozen: dict) -> tuple[dict, dict]:
    """(flat tensors, metadata) of the checkpoint file: the trainable
    tensors in their dtype, the stored LoRA alphas from ``frozen``, and the
    EMA shadow under its UNet-relative names with its decay and count."""
    tensors = {k: v.detach() for k, v in state.trainable.items()}
    for k, v in frozen.items():
        if k.endswith(".lora_alpha"):
            tensors[k] = v
    meta = {"step": int(state.step)}
    if state.ema is not None:
        for k, v in state.ema.shadow.items():
            rel = k[len(UNET_PREFIX) + 1:] if k.startswith(UNET_PREFIX + ".") else k
            tensors[EMA_PREFIX + rel] = v.detach()
        meta["ema_decay"] = float(state.ema.decay)
        meta["ema_num_updates"] = int(state.ema.num_updates)
    return tensors, meta


def _flatten(obj: Any, prefix: str, tensors: dict, numbers: dict) -> None:
    """Optimizer state -> tensors and numbers under dotted paths: dataclass
    fields and dict keys extend the path."""
    if isinstance(obj, torch.Tensor):
        tensors[prefix] = obj.detach()
        return
    if isinstance(obj, int) and not isinstance(obj, bool):
        numbers[prefix] = obj
        return
    if isinstance(obj, dict):
        items = obj.items()
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj))
    else:
        raise TypeError(f"{prefix}: cannot store {type(obj).__name__} in a checkpoint")
    for k, v in items:
        _flatten(v, f"{prefix}.{k}", tensors, numbers)


def _restore(template: Any, prefix: str, tensors: dict, numbers: dict) -> Any:
    """The inverse of ``_flatten`` over ``template``: tensors copied into the
    template's in place, numbers replaced; returns the restored object."""
    if isinstance(template, torch.Tensor):
        src = tensors[prefix]
        if src.shape != template.shape or src.dtype != template.dtype:
            raise ValueError(f"{prefix}: {tuple(src.shape)} {src.dtype} in the file, "
                             f"{tuple(template.shape)} {template.dtype} in the state")
        template.copy_(src)
        return template
    if isinstance(template, int):
        return int(numbers[prefix])
    if isinstance(template, dict):
        return {k: _restore(v, f"{prefix}.{k}", tensors, numbers)
                for k, v in template.items()}
    return dataclasses.replace(template, **{
        f.name: _restore(getattr(template, f.name), f"{prefix}.{f.name}", tensors, numbers)
        for f in dataclasses.fields(template)})


def train_state_dict(state: TrainState) -> tuple[dict, dict]:
    """(tensors, numbers) of the exact-resume sidecar."""
    tensors: dict = {}
    numbers: dict = {"step": int(state.step)}
    _flatten(state.opt_state, "opt_state", tensors, numbers)
    tensors[GENERATOR_KEY] = state.generator.get_state()
    return tensors, numbers


def save_checkpoint(path: Path, state: TrainState, frozen: dict,
                    loop_state: Optional[dict] = None,
                    extra_meta: Optional[dict] = None, parallel=None) -> None:
    """Write the checkpoint file and its sidecar (rank 0 writes).
    ``loop_state`` ({epoch, batch_in_epoch}) rides in the metadata, so a
    resume can fast-forward the data pipeline mid-epoch; ``extra_meta`` too
    (the trainer's ``ti_tokens``). ``parallel`` with sharded masters: a
    collective call, the ranks' leaves gathered on rank 0."""
    sharded = parallel is not None and parallel.sharded
    if not (sharded or is_main_process()):
        return
    path = Path(path)
    tensors, meta = checkpoint_state_dict(state, frozen)
    side, numbers = train_state_dict(state)
    if sharded:
        tensors, side = parallel.gather(tensors), parallel.gather(side)
        if not is_main_process():
            return
    if loop_state:
        meta.update({k: int(v) for k, v in loop_state.items()})
    if extra_meta:
        meta.update(extra_meta)
    path.parent.mkdir(parents=True, exist_ok=True)
    save_state_dict(tensors, path, metadata={"json": json.dumps(meta)})
    save_state_dict(side, sidecar_path(path), "safetensors",
                    metadata={"json": json.dumps(numbers)})


def load_checkpoint_tensors(path: Path) -> tuple[dict, dict]:
    tensors = load_state_dict(path)
    md = load_metadata(path) or {}
    return tensors, json.loads(md.get("json", "{}"))


def load_loop_state(path: Path) -> dict:
    """{epoch, batch_in_epoch} from the checkpoint metadata (None where the
    checkpoint predates loop-state persistence)."""
    md = load_metadata(path) or {}
    meta = json.loads(md.get("json", "{}"))
    return {"epoch": meta.get("epoch"), "batch_in_epoch": meta.get("batch_in_epoch")}


def split_checkpoint(tensors: dict, meta: dict) -> tuple[dict, Optional[dict]]:
    """-> (trainable params, EMA state dict or None)."""
    trainable = {k: v for k, v in tensors.items() if not k.startswith("unet_ema.")}
    shadow = {UNET_PREFIX + "." + k[len(EMA_PREFIX):]: v
              for k, v in tensors.items() if k.startswith(EMA_PREFIX)}
    ema = None
    if shadow:
        ema = {"decay": meta.get("ema_decay", 0.995),
               "num_updates": meta.get("ema_num_updates", 0),
               "shadow_params": shadow}
    return trainable, ema


def restore_jax_opt_state(ts_path: Path, template: Any,
                          pack_spec: Optional[PackSpec] = None) -> tuple[Any, int]:
    """(optimizer state, step) from a JAX ``.trainstate``: each family's
    optax state mapped onto the port's, slab moments unpacked by
    ``pack_spec`` (the JAX run's packing), copied into ``template``'s
    tensors in place (shapes and dtypes must agree)."""
    from ..convert.from_jax import opt_state_from_jax

    tree = read_flax_state(Path(ts_path).read_bytes())
    opt = opt_state_from_jax(tree["opt_state"], device="cpu", pack_spec=pack_spec)
    tensors: dict = {}
    numbers: dict = {}
    _flatten(opt, "opt_state", tensors, numbers)
    return (_restore(template, "opt_state", tensors, numbers),
            int(tree["step"].item() if isinstance(tree["step"], torch.Tensor)
                else tree["step"]))


@torch.no_grad()
def restore_train_state(path: Path, template_state: TrainState,
                        pack_spec: Optional[PackSpec] = None) -> TrainState:
    """Exact resume: the parameters from the checkpoint, and the optimizer
    state, step and generator from the port's sidecar, each copied into the
    template state's tensors in place (cast to the template's dtype: a
    bf16-master state takes bf16 whatever the file holds). With EMA on, the
    file's shadow, decay and count replace the template's (a file without
    one leaves the template's); with EMA off the file's shadow is ignored.
    Without the port's sidecar, a JAX sidecar next to the file gives the
    optimizer state and the step (``restore_jax_opt_state``; ``pack_spec``:
    the packing the JAX run's config implies) and the generator stays the
    template's; without either the step is the file's."""
    path = Path(path)
    tensors, meta = load_checkpoint_tensors(path)
    trainable_file, ema_file = split_checkpoint(tensors, meta)
    loaded = 0
    for k, v in template_state.trainable.items():
        if k in trainable_file:
            v.copy_(trainable_file[k].to(v.dtype))
            loaded += 1
    logger.info(f"Restored {loaded}/{len(template_state.trainable)} trainable params "
                f"({len(trainable_file)} tensors on disk)")
    ema = template_state.ema
    if ema is not None and ema_file is not None:
        shadow = ema_file["shadow_params"]
        missing = sorted(set(ema.shadow) - set(shadow))
        if missing:
            raise ValueError(f"{path}: the EMA shadow lacks {len(missing)} keys, e.g. "
                             f"{missing[0]}")
        for k, v in ema.shadow.items():
            v.copy_(shadow[k].to(v.dtype))
        ema = dataclasses.replace(ema, num_updates=int(ema_file["num_updates"]),
                                  decay=float(ema_file["decay"]))
        logger.info(f"Restored the EMA shadow ({len(shadow)} tensors, "
                    f"{ema.num_updates} updates)")
    template_state = template_state._replace(ema=ema)

    side = sidecar_path(path)
    if not side.exists():
        jax_side = Path(str(path) + JAX_SIDECAR_SUFFIX)
        if jax_side.exists():
            opt_state, step = restore_jax_opt_state(jax_side, template_state.opt_state,
                                                    pack_spec)
            logger.info(f"Restored the JAX run's optimizer state at step {step} from "
                        f"{jax_side.name}")
            logger.warning("the JAX run's PRNG key does not carry over: noise and "
                           "timesteps continue from this run's torch.Generator")
            return template_state._replace(step=step, opt_state=opt_state)
        return template_state._replace(step=int(meta.get("step", template_state.step)))
    side_tensors = load_state_dict(side, "safetensors")
    numbers = json.loads((load_metadata(side) or {}).get("json", "{}"))
    opt_state = _restore(template_state.opt_state, "opt_state", side_tensors, numbers)
    template_state.generator.set_state(side_tensors[GENERATOR_KEY])
    logger.info(f"Restored optimizer state at step {numbers['step']}")
    return template_state._replace(step=int(numbers["step"]), opt_state=opt_state)


class CheckpointManager:
    """File-name templating and retention (the reference's ModelCheckpoint
    knobs). Best-k retention state is kept in ``run_dir/retention.json``, so
    a resumed run goes on pruning the checkpoints from before."""

    def __init__(self, run_dir: Path, config, parallel=None):
        self.run_dir = Path(run_dir)
        self.parallel = parallel
        self.filename = config.get("filename", "{epoch}-{train_loss:.2f}")
        self.auto_insert_metric_name = config.get("auto_insert_metric_name", True)
        self.every_n_epochs = config.get("every_n_epochs")
        self.every_n_train_steps = config.get("every_n_train_steps")
        self.save_top_k = config.get("save_top_k", -1)
        self.monitor = config.get("monitor")
        self.mode = config.get("mode", "min")
        self._saved: list[tuple[float, Path]] = self._load_retention()

    @property
    def _retention_path(self) -> Path:
        return self.run_dir / "retention.json"

    def _load_retention(self) -> list[tuple[float, Path]]:
        try:
            entries = json.loads(self._retention_path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return []
        # drop entries whose files were removed out of band
        return [(float(s), Path(p)) for s, p in entries if Path(p).exists()]

    def _store_retention(self) -> None:
        self._retention_path.parent.mkdir(parents=True, exist_ok=True)
        self._retention_path.write_text(json.dumps([[s, str(p)] for s, p in self._saved]))

    def _format_name(self, metrics: dict) -> str:
        def repl(m):
            key, fmt = m.group(1), m.group(2) or ""
            value = metrics.get(key, 0)
            prefix = f"{key}=" if self.auto_insert_metric_name else ""
            return prefix + format(value, fmt.lstrip(":")) if fmt else f"{prefix}{value}"

        return re.sub(r"\{([\w.]+)(:[^}]*)?\}", repl, self.filename)

    def save(self, state: TrainState, frozen: dict, metrics: dict,
             loop_state: Optional[dict] = None, extra_meta: Optional[dict] = None) -> Path:
        """Write the checkpoint (collective under sharded masters), then
        prune to ``save_top_k`` by ``monitor`` (rank 0 only)."""
        path = self.run_dir / (self._format_name(metrics) + ".safetensors")
        save_checkpoint(path, state, frozen, loop_state=loop_state, extra_meta=extra_meta,
                        parallel=self.parallel)
        if not is_main_process():
            return path
        logger.info(f"Saved checkpoint {path}")
        if self.monitor and self.save_top_k and self.save_top_k > 0:
            self._saved.append((float(metrics.get(self.monitor, 0.0)), path))
            self._saved.sort(key=lambda t: t[0], reverse=self.mode == "max")
            while len(self._saved) > self.save_top_k:
                _, victim = self._saved.pop()
                victim.unlink(missing_ok=True)
                sidecar_path(victim).unlink(missing_ok=True)
                logger.info(f"Retention: removed {victim}")
            self._store_retention()
        return path
