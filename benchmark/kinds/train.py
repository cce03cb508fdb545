"""Training cells: a full fine-tune of the configuration's denoiser through
the program's own step (``training/step.py`` ``make_train_step`` over the
state of ``init_train_state`` and the optimizer of ``training/optimizers.py``
``build_optimizer``), fed from a latent cache on the device.

The traffic mix gives the batch, the resolution, the conditioning length,
the cache's rows, the compute precision (the port's ``trainer.precision``)
and the optimizer (AdamW's hyperparameters, master and
moment dtypes). Set-up makes the weights and the cache from the seed, builds
the state once and drives it through its first ``check_steps`` steps (the
same call and feed as the window, consecutive rows of the cache, so no row
repeats), which also warm every shape; the window then runs that same object
on. Each step takes the benchmark's draws (noise and timesteps, from the
seed) through the step's ``draws`` argument.

What is compared (``numbers``): each check step's loss, the first gradient
as the optimizer holds it after step 1 (its first moment over 1 - beta1),
and each leaf's change after the check steps, against the plain reference
run over the same inputs from the same weights. Norms are taken per leaf;
a gap is |program - reference| over the larger of the leaf's reference norm
and the median leaf's. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change. Frozen tables are served in bf16 on both sides.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark.harness.weights import generator, make_weights
from benchmark.reference.diffusion import AdamW, noisy_and_target

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
QUIET_GRAD = 1e-3    # a leaf's reference gradient under this share of the median leaf's
RATE = "train_images_per_s"


def _norms(tensors) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]).cpu()


class Feed:
    """Batches of consecutive cache rows, with the draws of each step."""

    def __init__(self, cell, family, seed: int, device):
        cfg, t = cell.config, cell.traffic
        self.family, self.cfg, self.batch, self.device = family, cfg, t["batch"], device
        gen = generator(seed, device, "cache")
        rows = t["cache_rows"]
        self.cache = {"latents": torch.randn((rows,) + family.latent_shape(cfg, t["resolution"]),
                                             generator=gen, device=device)}
        for key, shape in family.cond_shapes(cfg, t).items():
            self.cache[key] = torch.randn((rows,) + shape, generator=gen, device=device)
        self.rows = rows
        self.gen = generator(seed, device, "draws")
        self.next_row = 0

    def next(self):
        from scal_sdt_tpu_torch.training.step import Draws

        if self.next_row + self.batch > self.rows:
            self.next_row = 0
        s = slice(self.next_row, self.next_row + self.batch)
        self.next_row += self.batch
        batch = {k: v[s] for k, v in self.cache.items()}
        noise = torch.randn(batch["latents"].shape, generator=self.gen, device=self.device,
                            dtype=torch.bfloat16)
        t = self.family.draw_timesteps(self.cfg, self.gen, self.batch, self.device)
        return batch, Draws(noise=noise, timesteps=t)


def _half(batch: dict, draws):
    """Half of the batch left out: the step sees the first half alone."""
    from scal_sdt_tpu_torch.training.step import Draws

    n = draws.noise.shape[0] // 2
    return ({k: v[:n] for k, v in batch.items()},
            Draws(noise=draws.noise[:n], timesteps=draws.timesteps[:n]))


class Work:
    unit_name = "steps"
    rate_name = RATE

    def __init__(self, cell, seed: int, device, family, fault: str | None = None):
        self.cell, self.seed, self.device, self.family, self.fault = cell, seed, device, family, fault
        t = cell.traffic
        self.images_per_unit = t["batch"]
        self.trace_units = t["trace_steps"]
        self.opt = t["optimizer"]
        self.master_dtype = DTYPES[self.opt["master_dtype"]]

    # --- the program --------------------------------------------------------------

    def _port_config(self):
        from scal_sdt_tpu_torch.conf import Config, default, merge

        o = self.opt
        optimizer = {"name": "adamw", "master_dtype": o["master_dtype"],
                     "params": {"lr": o["lr"], "beta1": o["beta1"], "beta2": o["beta2"],
                                "weight_decay": o["weight_decay"], "eps": o["eps"]},
                     "lr_scale": {"enabled": False},
                     "lr_scheduler": {"name": "constant",
                                      "params": {"factor": 1.0, "total_iters": 0}}}
        if o["moment_dtype"] is not None:
            optimizer["moment_dtype"] = o["moment_dtype"]
        return merge(default(), Config({
            "batch_size": self.cell.traffic["batch"], "gradient_checkpointing": False,
            "trainer": {"precision": self.cell.traffic["precision"]}, "ema": {"enabled": False},
            "optimizer": optimizer}))

    def setup(self) -> None:
        from scal_sdt_tpu_torch.conf import load_optim_target
        from scal_sdt_tpu_torch.training.optim_targets import group_labels, resolve_optim_target
        from scal_sdt_tpu_torch.training.optimizers import build_optimizer
        from scal_sdt_tpu_torch.training.step import (init_train_state, loss_and_grads,
                                                      make_train_step)

        fam, cfg = self.family, self.cell.config
        clock = time.perf_counter()
        config = self._port_config()
        params = make_weights(fam.shapes(cfg), self.seed, self.device, self.master_dtype,
                              fam.fixed(cfg))
        res = resolve_optim_target(load_optim_target("full_unet"), params.keys(), [])
        trainable = {f"unet.{k}": params.pop(k) for k in res["unet"].trainable}
        frozen = {f"unet.{k}": v.to(torch.bfloat16) for k, v in params.items()}
        if sorted(params) != sorted(getattr(fam, "FROZEN", ())):
            raise RuntimeError(f"leaves outside the full_unet target: {sorted(params)}")
        del params
        labels = group_labels(res)
        overrides = {f"g{i}": g.optimizer for i, g in enumerate(res["unet"].groups)}
        tx, lr_fn = build_optimizer(config, labels, overrides, steps_per_epoch=1000,
                                    num_processes=1)
        spec = fam.program_step_spec(cfg, config)
        state = init_train_state(trainable, tx, seed=self.seed)
        step_fn = make_train_step(spec, tx, lr_fn)
        if self.fault == "unchanged":
            def step_fn(state, frozen_, batch, draws=None):
                loss, _ = loss_and_grads(spec, state.trainable, frozen_, batch, None, draws)
                return state, {"train_loss": loss}
        elif self.fault == "half_batch":
            real = step_fn

            def step_fn(state, frozen_, batch, draws=None):
                return real(state, frozen_, *_half(batch, draws))
        elif self.fault is not None:
            raise ValueError(f"no such training fault: {self.fault!r}")
        self.keys = sorted(trainable)
        self.shapes = [tuple(trainable[k].shape) for k in self.keys]
        self.feed = Feed(self.cell, fam, self.seed, self.device)
        self.state, self.frozen, self.step_fn = state, frozen, step_fn
        self.phases = {"build": time.perf_counter() - clock}
        clock = time.perf_counter()

        # the check steps: the window's own call and feed, rows that all differ
        self.check_inputs, losses = [], []
        for i in range(self.cell.traffic["check_steps"]):
            batch, draws = self.feed.next()
            self.check_inputs.append((batch, draws))
            self.state, metrics = self.step_fn(self.state, self.frozen, batch, draws)
            losses.append(metrics["train_loss"])
            if i == 0:
                mu = {k: v for s in self.state.opt_state.values() for k, v in s.mu.items()}
                grad = _norms(mu[k] for k in self.keys) / (1.0 - self.opt["beta1"])
        self.phases["check_steps"] = time.perf_counter() - clock
        init = make_weights(fam.shapes(cfg), self.seed, self.device, self.master_dtype,
                            fam.fixed(cfg))
        change = _norms(self.state.trainable[k].float() - init[k[len("unet."):]].float()
                        for k in self.keys)
        del init
        self.readings = {"loss": torch.stack([x.float() for x in losses]).cpu(), "grad": grad,
                         "change": change}

    def control_inputs(self) -> None:
        """The check steps' inputs alone, for the control (no program)."""
        fam, cfg = self.family, self.cell.config
        frozen = set(getattr(fam, "FROZEN", ()))
        shapes = fam.shapes(cfg)
        self.keys = sorted(f"unet.{k}" for k in shapes if k not in frozen)
        self.shapes = [shapes[k[len("unet."):]] for k in self.keys]
        self.feed = Feed(self.cell, fam, self.seed, self.device)
        self.check_inputs = [self.feed.next() for _ in range(self.cell.traffic["check_steps"])]

    def unit(self) -> None:
        batch, draws = self.feed.next()
        self.state, _ = self.step_fn(self.state, self.frozen, batch, draws)

    def program_readings(self) -> dict:
        return self.readings

    def release(self) -> None:
        self.state = self.frozen = self.step_fn = None

    # --- the reference ------------------------------------------------------------

    def reference_readings(self, nx) -> dict:
        fam, cfg, t = self.family, self.cell.config, self.cell.traffic
        sched = fam.schedule(cfg)
        init = make_weights(fam.shapes(cfg), self.seed, self.device, self.master_dtype,
                            fam.fixed(cfg))
        names = [k[len("unet."):] for k in self.keys]
        frozen = set(getattr(fam, "FROZEN", ()))
        params = {k: (v.to(torch.bfloat16) if k in frozen else v).float().clone()
                  .requires_grad_(k in names) for k, v in init.items()}
        o = self.opt
        opt = AdamW(o["lr"], o["beta1"], o["beta2"], o["eps"], o["weight_decay"],
                    self.master_dtype, seed=self.seed, device=self.device)
        rows = t["reference_rows"]
        losses, grad = [], None
        for i, (batch, draws) in enumerate(self.check_inputs):
            for k in names:
                params[k].grad = None
            total = batch["latents"].numel()
            loss = 0.0
            for s in range(0, batch["latents"].shape[0], rows):
                sub = {k: v[s:s + rows].float() for k, v in batch.items()}
                x_t, target = noisy_and_target(sched, sub["latents"],
                                               draws.noise[s:s + rows].float(),
                                               draws.timesteps[s:s + rows])
                pred = fam.reference_forward(params, x_t, draws.timesteps[s:s + rows], sub,
                                             cfg, nx)
                part = torch.square(pred - target).sum() / total
                part.backward()
                loss += float(part.detach())
            losses.append(loss)
            grads = {k: params[k].grad for k in names}
            if i == 0:
                grad = _norms(grads[k] for k in names)
            opt.step({k: params[k] for k in names}, grads)
        change = _norms(params[k].detach() - init[k].float() for k in names)
        return {"loss": torch.tensor(losses), "grad": grad, "change": change}

    # --- the comparison -----------------------------------------------------------

    def explain(self, prog: dict, ref: dict) -> dict:
        """Which leaf reads the worst gradient and change gaps, and its size."""
        out = {}
        for what in ("grad", "change"):
            gap = (prog[what].double() - ref[what].double()).abs() / torch.clamp(
                ref[what].double(), min=float(ref[what].median()))
            if what == "change":
                moving = ref["grad"] >= QUIET_GRAD * float(ref["grad"].median())
                gap = torch.where(moving, gap, torch.zeros_like(gap))
            i = int(gap.argmax())
            out[what] = {"leaf": self.keys[i], "numel": math.prod(self.shapes[i]),
                         "program": float(prog[what][i]), "reference": float(ref[what][i])}
        return out

    @staticmethod
    def numbers(prog: dict, ref: dict) -> dict:
        def worst_and_median(p, r, keep):
            p, r = p[keep].double(), r[keep].double()
            gap = (p - r).abs() / torch.clamp(r, min=float(r.median()))
            return float(gap.max()), float(gap.median())

        loss = float(((prog["loss"].double() - ref["loss"].double()).abs()
                      / ref["loss"].double().abs()).max())
        everything = torch.ones_like(ref["grad"], dtype=torch.bool)
        grad, _ = worst_and_median(prog["grad"], ref["grad"], everything)
        moving = ref["grad"] >= QUIET_GRAD * float(ref["grad"].median())
        update, update_median = worst_and_median(prog["change"], ref["change"], moving)
        out = {"loss": loss, "grad": grad, "update": update, "update_median": update_median,
               "quiet_leaves": float((~moving).sum())}
        return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
