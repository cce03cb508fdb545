"""LR schedules with torch-scheduler semantics (port of
``scal_sdt_tpu/training/schedules.py``).

A schedule maps an integer optimizer step to a multiplier of the group's base
lr. The step lives on the host in the port, so the schedule is host math; it
runs in float32 like the jnp version so both give the same multiplier.
Torch dotted names are accepted as aliases.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], np.float32]  # step -> multiplier of base lr

_F = np.float32

_SCHEDULE_ALIASES = {
    "torch.optim.lr_scheduler.constantlr": "constant",
    "torch.optim.lr_scheduler.cosineannealinglr": "cosine",
    "torch.optim.lr_scheduler.linearlr": "linear",
    "constantlr": "constant",
    "cosineannealinglr": "cosine",
    "cosine_annealing": "cosine",
}


def _canonical(name: str) -> str:
    n = str(name).lower()
    return _SCHEDULE_ALIASES.get(n, n)


def build_base_schedule(name: str, params: dict, steps_per_epoch: int,
                        base_lr: float = 1.0) -> Schedule:
    """`params` uses the torch scheduler's kwargs; epochs may be fractional.
    ``base_lr`` turns absolute kwargs such as ``eta_min`` into multipliers."""
    name = _canonical(name)
    spe = _F(max(steps_per_epoch, 1))

    if name == "constant":
        # torch ConstantLR defaults: lr/3 for the first 5 (fractional) epochs.
        factor = _F(params.get("factor", 1.0 / 3))
        total_iters = _F(params.get("total_iters", 5))

        def constant(step):
            return factor if _F(step) / spe < total_iters else _F(1.0)

        return constant

    if name == "cosine":
        t_max = _F(params.get("T_max", 1))
        eta_min = float(params.get("eta_min", 0.0))
        eta_frac = _F(eta_min / base_lr if base_lr > 0 else 0.0)

        def cosine(step):
            epoch = min(_F(step) / spe, t_max)
            cos_out = (_F(1.0) + np.cos(_F(np.pi) * epoch / t_max)) / _F(2.0)
            return eta_frac + (_F(1.0) - eta_frac) * cos_out

        return cosine

    if name == "linear":
        start = _F(params.get("start_factor", 1.0 / 3))
        end = _F(params.get("end_factor", 1.0))
        total = _F(params.get("total_iters", 5))

        def linear(step):
            epoch = min(_F(step) / spe, total)
            return start + (end - start) * (epoch / total)

        return linear

    raise ValueError(f"Unknown lr scheduler: {name}")


def wrap_warmup(base: Schedule, base_lr: float, init_lr: float,
                num_warmup: int, strategy: str) -> Schedule:
    """Ramp from min(init_lr, base_lr) to base_lr over `num_warmup` steps,
    then the base schedule with the warmup steps subtracted."""
    start_mult = _F(min(init_lr, base_lr) / base_lr if base_lr > 0 else 0.0)
    nw = max(num_warmup, 1)

    def ramp(pct):
        if strategy == "linear":
            return start_mult + (_F(1.0) - start_mult) * pct
        if strategy == "cosine":
            cos_out = np.cos(_F(np.pi) * pct) + _F(1.0)
            return _F(1.0) + (start_mult - _F(1.0)) / _F(2.0) * cos_out
        if strategy == "constant":
            return start_mult if pct < _F(0.9999) else _F(1.0)
        raise ValueError(f"Unknown warmup strategy: {strategy}")

    def schedule(step):
        if step <= num_warmup:
            return ramp(_F(min(step, nw)) / _F(nw))
        return base(max(step - num_warmup, 0))

    return schedule


def build_lr_schedule(optimizer_config, base_lr: float, steps_per_epoch: int) -> Schedule:
    """Full schedule from the `optimizer.lr_scheduler` config section."""
    sched_conf = optimizer_config.lr_scheduler
    base = build_base_schedule(sched_conf.name, dict(sched_conf.get("params", {})),
                               max(steps_per_epoch, 1), base_lr)
    warmup = sched_conf.get("warmup")
    if warmup is not None and warmup.get("enabled", False):
        base = wrap_warmup(base, base_lr,
                           float(warmup.get("init_lr", 7e-8)),
                           int(warmup.get("steps", 100)),
                           warmup.get("strategy", "linear"))
    return base
