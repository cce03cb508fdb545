"""One rank of a multi-process world for tests/test_torch_parallel.py.

Run as ``python tests/torch_parallel_worker.py JOBS.json`` in each of N
processes with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): the
world joins one gloo process group on the CPU and runs the jobs in order,
each rank writing what it holds into the job's directory. Imports torch and
the port only (no JAX), so a world starts in seconds.

Jobs (dicts with ``kind``):

* ``train``: the port's Trainer on ``config`` (a full config dict) with
  the global batch's ``draws`` (seeded, or read from a file), ``steps``
  steps, an optional ``resume`` checkpoint and a final checkpoint with
  ``save`` (with 0 steps, the resumed state saved at once), and an optional
  planted ``fault`` (``plant_fault``) for the bounds' negative controls;
  each rank writes ``rank{r}.safetensors`` (its masters under ``m.``, its
  compute copies under ``c.``, its EMA shadows under ``e.``, its optimizer
  state under ``o.``) and ``rank{r}.json`` (losses, the mesh, owned keys,
  the steps after which the compute copies were broadcast).
* ``optimizer``: ``build_optimizer`` of ``config`` over ``shapes`` with the
  leaves split over the world's owners, ``steps`` updates of seeded
  gradients; each rank writes its masters and optimizer state.
* ``cache``: ``cli.cache`` with ``args``, each batch's latent noise
  replayed from ``noise`` (``{rank}.{batch}`` tensors) when given.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.parallel.mesh import LaunchEnv, init_process_group
from scal_sdt_tpu_torch.training.checkpoint import _flatten
from scal_sdt_tpu_torch.training.step import Draws, draw
from scal_sdt_tpu_torch.utils.state import save_state_dict


def seeded_draws(spec, latent_shape, seed: int, uncached: bool):
    """``draws_fn(step)``: the global batch's draws from a generator seeded
    by (seed, step), the same in every process."""
    def draws_fn(step: int) -> Draws:
        gen = torch.Generator().manual_seed(seed * 1000 + step)
        latents = torch.empty(latent_shape, dtype=spec.compute_dtype)
        noise = (torch.randn(latent_shape, generator=gen, dtype=torch.float32)
                 if uncached else None)
        u = torch.rand((), generator=gen) if spec.uncond_enabled else None
        return draw(gen, spec, latents, noise, u)
    return draws_fn


def file_draws(path: str):
    """``draws_fn(step)`` of draws stored as ``{step}.{field}`` tensors."""
    from scal_sdt_tpu_torch.utils.state import load_state_dict

    stored = load_state_dict(Path(path))

    def draws_fn(step: int) -> Draws:
        return Draws(noise=stored[f"{step}.noise"], timesteps=stored[f"{step}.timesteps"],
                     latent_noise=stored.get(f"{step}.latent_noise"))
    return draws_fn


def draws_of(spec, d: dict):
    if "file" in d:
        return file_draws(d["file"])
    return seeded_draws(spec, tuple(d["shape"]), d["seed"], d["uncached"])


def seeded_grads(shapes: dict, dtype, step: int) -> dict:
    gen = torch.Generator().manual_seed(7919 + step)
    return {k: (torch.randn(s, generator=gen) * 1e-2).to(dtype) for k, s in sorted(shapes.items())}


def state_tensors(state) -> tuple[dict, dict]:
    """(tensors, numbers) of a TrainState: masters, compute copies, EMA
    shadows, optimizer state."""
    tensors: dict = {}
    numbers: dict = {}
    for k, v in state.trainable.items():
        tensors[f"m.{k}"] = v.detach()
    for k, v in (state.compute or {}).items():
        tensors[f"c.{k}"] = v.detach()
    if state.ema is not None:
        for k, v in state.ema.shadow.items():
            tensors[f"e.{k}"] = v.detach()
    _flatten(state.opt_state, "o", tensors, numbers)
    return tensors, numbers


def _write(out: Path, rank: int, tensors: dict, info: dict) -> None:
    out.mkdir(parents=True, exist_ok=True)
    save_state_dict({k: v.contiguous().cpu() for k, v in tensors.items()},
                    out / f"rank{rank}.safetensors")
    (out / f"rank{rank}.json").write_text(json.dumps(info))


def plant_fault(parallel, fault: str) -> None:
    """A deliberately wrong world: the gradient reduction without the
    data-parallel all-reduce (``skip_dp``: each rank steps on its own rows'
    mean) or without the tensor group's sum of the partial gradients
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


def train_job(job: dict, env: LaunchEnv) -> None:
    from scal_sdt_tpu_torch.training.trainer import Trainer

    cfg = tconf.merge(tconf.default(), tconf.Config(job["config"]))
    tr = Trainer(cfg, Path(job["run_dir"]), device="cpu", backend="gloo")
    if job.get("resume"):
        tr.resume(Path(job["resume"]))
    if job.get("fault"):
        plant_fault(tr.parallel, job["fault"])
    refreshed = []
    if tr.parallel is not None:
        real_refresh = tr.parallel.refresh_compute
        tr.parallel.refresh_compute = lambda c, m: (refreshed.append(tr.global_step),
                                                    real_refresh(c, m))
    losses = []
    real = tr._log
    tr._log = lambda m, s: (losses.append([s, m["train_loss"]]), real(m, s))
    if job["steps"]:
        tr.fit(max_steps_override=tr.global_step + job["steps"],
               final_save=job.get("save", False), draws_fn=draws_of(tr.spec, job["draws"]))
    elif job.get("save"):
        tr._save(tr.epoch_cursor, {})
    tensors, numbers = state_tensors(tr.state)
    owned = sorted(tr.state.trainable)
    _write(Path(job["out"]), env.rank, tensors,
           {"losses": losses, "numbers": numbers, "owned": owned,
            "mesh": list(tr.mesh.shape), "coord": list(tr.mesh.coord),
            "rows": tr.parallel.rows.index.tolist() if tr.parallel else None,
            "step": tr.global_step, "refreshed": refreshed})


def optimizer_job(job: dict, env: LaunchEnv) -> None:
    from scal_sdt_tpu_torch.parallel.mesh import mesh_from_config
    from scal_sdt_tpu_torch.parallel.sharding import Parallel
    from scal_sdt_tpu_torch.training.families import GroupOwners
    from scal_sdt_tpu_torch.training.optimizers import build_optimizer
    from scal_sdt_tpu_torch.training.trainer import jax_pack_spec

    cfg = tconf.merge(tconf.default(), tconf.Config(job["config"]))
    mesh = mesh_from_config(cfg.trainer, env)
    dtype = getattr(torch, job["master_dtype"])
    grad_dtype = getattr(torch, job["grad_dtype"])
    shapes = {k: tuple(v) for k, v in job["shapes"].items()}
    labels = job["labels"]
    gen = torch.Generator().manual_seed(11)
    masters = {k: torch.randn(s, generator=gen).to(dtype) for k, s in sorted(shapes.items())}
    pack = jax_pack_spec(cfg, {k: v.float() for k, v in masters.items()}, labels)
    units = ([[s.key for s in slots] for _, _, slots in pack.slabs]
             + [list(m) for _, m, _ in pack.stacks]) if pack is not None else []
    par = Parallel(mesh, {k: (v.shape, v.dtype) for k, v in masters.items()}, units=units)
    owned = par.owned(masters)

    def group_sum(x):
        total = x.detach().float().clone()
        dist.all_reduce(total, group=mesh.group("model"))
        return total

    tx, _ = build_optimizer(cfg, {k: v for k, v in labels.items() if k in owned},
                            {g: {} for g in sorted(set(labels.values()))}, 10, 1,
                            pack_spec=pack, owners=GroupOwners(group_sum, (grad_dtype, dtype)))
    state = tx.init(owned)
    for step in range(job["steps"]):
        grads = seeded_grads(shapes, grad_dtype, step)
        state = tx.update_and_apply({k: grads[k] for k in owned}, state, owned, step)
    tensors = {f"m.{k}": v for k, v in owned.items()}
    numbers: dict = {}
    _flatten(state, "o", tensors, numbers)
    _write(Path(job["out"]), env.rank, tensors, {"owned": sorted(owned), "numbers": numbers})


def cache_job(job: dict, env: LaunchEnv) -> None:
    from scal_sdt_tpu_torch.cli import cache
    from scal_sdt_tpu_torch.utils.state import load_state_dict

    if job.get("noise"):
        stored = load_state_dict(Path(job["noise"]))
        mine = iter([stored[k] for k in sorted((k for k in stored
                                                if k.startswith(f"{env.rank}.")),
                                               key=lambda k: int(k.split(".")[1]))])
        cache.latent_noise_source = lambda seed, device: (lambda moments: next(mine))
    cache.main(job["args"], standalone_mode=False)


def main() -> None:
    jobs = json.loads(Path(sys.argv[1]).read_text())
    env = LaunchEnv.from_environ()
    init_process_group(torch.device("cpu"), "gloo", env)
    for job in jobs:
        {"train": train_job, "optimizer": optimizer_job, "cache": cache_job}[job["kind"]](job, env)
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
