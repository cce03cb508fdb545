"""The port's multi-process training against its single process and JAX, on
the CPU over gloo.

* The mesh functions against ``scal_sdt_tpu/parallel/mesh.py`` on the same
  inputs: the mesh shape and its errors, each rank's (data, fsdp, tensor)
  coordinate against the device positions of JAX's mesh, ``tp_dim`` and
  ``tp_param_names`` over the tiny UNet's and MMDiT's names (LoRA factors
  included), and the refusal of a tensor axis across hosts.
* Worlds of processes (``torch_parallel_worker.py``, one gloo group each,
  spawned once per module and shared by the xdist workers through a file
  lock): the tiny UNet for 3 steps under meshes (2,1,1) (uncached), (1,2,1)
  and (1,1,2) (cached) on 2 ranks and (2,1,2) on 4 ranks; LoRA with tensor
  2 (GEGLU halves, LoRA factors read under the shard); the tiny SD3 MMDiT
  with tensor 2 (joint attention at H/2). Each is held against the port's
  single process on the same global batch and draws: losses within 1e-5,
  masters by ``_check_masters`` (fp32: 1e-4 of each tensor's largest entry
  in all but 1e-3 of the elements, 2 lr per step for those), first moments
  within 1e-4 and second moments within 1e-3 of each tensor's largest entry
  (fp32 compute: the worlds' gradients differ from one process's by the
  order of their sums). The (2,1,2) world is also held against the JAX
  Trainer's step on a (2,1,2) mesh of 4 of its 8 CPU devices, with JAX's
  draws. At bf16 compute, (1,2,1) and (1,1,2) within their own bound (the
  bound the card's parallel phase holds SD1.5 to).
* Owners: each fsdp owner's update of its leaves equals the single-process
  update bit for bit for AdamW (xla mode, and bf16 masters with bf16
  moments), AdamW8bit and Adafactor (packed slabs, one owner per slab, so
  the (s) blocks stay whole); Prodigy, whose group-wide sums add the
  owners' partial sums, within its difference (r) bound.
* Checkpoints: a world-2 checkpoint under (1,2,1) and (1,1,2) equals tensor
  for tensor the one a single process writes from the same state (the
  world's file resumed by one process and saved again); a single-process
  checkpoint and a JAX ``.trainstate`` resume under world 2, each rank
  holding its own leaves, and save back to the same files.
* ``cli.cache`` under 2 processes writes the JAX package's single-process
  cache (JAX's latent draws replayed per image id).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from filelock import FileLock

import jax

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import cache as jcache
from scal_sdt_tpu.models.mmdit import MMDiTConfig, mmdit_param_shapes
from scal_sdt_tpu.models.unet import UNetConfig, unet_param_shapes
from scal_sdt_tpu.parallel import mesh as jmesh
from scal_sdt_tpu.training import trainer as jtrainer_mod
from scal_sdt_tpu.training.trainer import Trainer as JTrainer
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import cache as tcache
from scal_sdt_tpu_torch.convert.from_jax import opt_state_from_jax
from scal_sdt_tpu_torch.data import pipeline as tpipeline
from scal_sdt_tpu_torch.parallel import mesh as tmesh
from scal_sdt_tpu_torch.parallel.sharding import assign_owners
from scal_sdt_tpu_torch.training.checkpoint import _flatten
from scal_sdt_tpu_torch.training.optimizers import build_optimizer
from scal_sdt_tpu_torch.training.trainer import jax_pack_spec
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils.state import load_metadata, load_state_dict, save_state_dict

from helpers import make_image_dataset, tiny_sd3_models
from test_torch_data import write_vocab
from torch_parallel_worker import draws_of, seeded_grads, state_tensors
from torch_port_helpers import jax_draws, tiny_model_dir, tiny_sd3_dir, to_np

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
BATCH, IMAGES, RES, LR, STEPS = 8, 16, 32, 1e-3, 3
LATENTS = (BATCH, RES // 2, RES // 2, 4)   # the tiny VAE downsamples 2x


# --- the mesh against JAX's --------------------------------------------------------------

MESHES = [((None, 1, 1), 8), ((None, 2, 1), 8), ((None, 2, 2), 8), ((2, 1, 2), 4),
          ((None, 1, 4), 8), ((4, 2, 1), 8), ((1, 2, 1), 2), ((1, 1, 2), 2)]


@pytest.mark.parametrize("axes,n", MESHES, ids=[f"{a}-{n}" for a, n in MESHES])
def test_mesh_matches_jax(axes, n):
    """The shape, and each rank at the position of device ``rank`` in JAX's
    ``reshape(data, fsdp, tensor)``."""
    devices = jax.devices()[:n]
    jm = jmesh.make_mesh(*axes, devices=devices)
    shape = tmesh.mesh_shape(*axes, n)
    assert shape == tuple(jm.devices.shape)
    position = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    for rank, dev in enumerate(devices):
        assert tmesh.coords(rank, shape) == position[dev.id]
        assert tmesh.rank_of(position[dev.id], shape) == rank


@pytest.mark.parametrize("axes,n", [((3, 1, 1), 8), ((None, 3, 1), 8), ((2, 2, 1), 8)])
def test_mesh_errors_match_jax(axes, n):
    with pytest.raises(AssertionError) as jerr:
        jmesh.make_mesh(*axes, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as terr:
        tmesh.mesh_shape(*axes, n)
    assert str(terr.value) == str(jerr.value)


def _named_shapes():
    """The tiny UNet's and tiny MMDiT's parameter shapes (tests/helpers.py
    ``tiny_sd3_models``'s MMDiT config) with LoRA factors on every linear of
    their attention and feed-forward blocks."""
    mmdit = MMDiTConfig(sample_size=8, patch_size=2, in_channels=4, out_channels=4,
                        num_layers=2, attention_head_dim=8, num_attention_heads=2,
                        joint_attention_dim=32, pooled_projection_dim=24,
                        pos_embed_max_size=12)
    shapes = {f"unet.{k}": tuple(v) for k, v in
              unet_param_shapes(UNetConfig.tiny()).items()}
    shapes.update({f"mmdit.{k}": tuple(v) for k, v in mmdit_param_shapes(mmdit).items()})
    for k, v in list(shapes.items()):
        if k.endswith(".weight") and len(v) == 2:
            base = k[:-len(".weight")]
            shapes[f"{base}.lora_A"], shapes[f"{base}.lora_B"] = (4, v[1]), (v[0], 4)
    return shapes


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_tp_rules_match_jax(tp):
    shapes = _named_shapes()
    for k, v in shapes.items():
        assert tmesh.tp_dim(k, v, tp) == jmesh.tp_dim(k, v, tp), k
    arrays = {k: np.empty(v, np.float32) for k, v in shapes.items()}
    names = tmesh.tp_param_names(arrays, tp)
    assert names == jmesh.tp_param_names(arrays, tp)
    assert bool(names) == (tp > 1)


def test_tensor_across_hosts_is_refused_with_jax_message():
    env = tmesh.LaunchEnv(rank=0, world=4, local_rank=0, local_world=2)
    with pytest.raises(NotImplementedError, match="single-host"):
        tmesh.check_mesh({"mesh": {"tensor": 2}}, env)
    assert tmesh.check_mesh({"mesh": {"fsdp": 2}}, env) == (2, 2, 1)


def test_host_rows_split_the_batch_over_data_and_fsdp():
    """Rows of an 8-row host batch: tensor peers share them, data x fsdp
    split them, in rank order; a batch the slots do not divide raises."""
    rows = {}
    for rank in range(8):
        env = tmesh.LaunchEnv(rank=rank, world=8, local_rank=rank, local_world=8)
        rows[rank] = tmesh.Mesh(shape=(2, 2, 2), rank=rank, env=env).host_rows(8)
    assert rows == {0: (0, 2), 1: (0, 2), 2: (2, 4), 3: (2, 4), 4: (4, 6), 5: (4, 6),
                    6: (6, 8), 7: (6, 8)}
    with pytest.raises(ValueError, match="batch_size 6 is not divisible by the 4"):
        tmesh.host_slots(6, tmesh.LaunchEnv(0, 8, 0, 8), 2)


def test_owners_are_balanced_and_keep_units_whole():
    sizes = {f"k{i}": (i % 5 + 1) * 100 for i in range(23)}
    owner = assign_owners(sizes, 3, units=[["k1", "k2", "k3"]])
    assert owner == assign_owners(dict(reversed(list(sizes.items()))), 3,
                                  units=[["k3", "k2", "k1"]])
    assert len({owner[k] for k in ("k1", "k2", "k3")}) == 1
    load = [sum(v for k, v in sizes.items() if owner[k] == i) for i in range(3)]
    assert max(load) - min(load) <= max(sizes.values()) * 3


# --- worlds of processes ----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(n: int, jobs: list, tmp: Path):
    """Spawn n ranks running ``jobs``; returns a function that waits for them."""
    path = tmp / f"jobs_{n}.json"
    path.write_text(json.dumps(jobs))
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", SSDT_INT8_FUSED_MIN="256",
                   PYTHONPATH=os.pathsep.join([str(WORKER.parent.parent), str(WORKER.parent)]))
        log = open(tmp / f"world{n}_rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(WORKER), str(path)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))

    def wait(timeout=300):
        for proc, log in procs:
            try:
                proc.wait(timeout=timeout)
            finally:
                log.close()
        for rank, (proc, _) in enumerate(procs):
            text = (tmp / f"world{n}_rank{rank}.log").read_text()
            assert proc.returncode == 0, f"rank {rank} of {n} failed:\n{text[-4000:]}"
    return wait


def _config(tmp: Path, model: Path, **extra) -> dict:
    user = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": BATCH,
            "seed": 3, "num_workers": 1,
            "data": {"resolution": RES, "concepts": [
                {"instance_set": {"path": str(tmp / "data"), "prompt": "{TXT_PROMPT}"}}]},
            "trainer": {"precision": "32", "max_epochs": 4, "param_packing": False},
            "optimizer": {"params": {"lr": LR}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    return dict(jconf.merge(user, extra))


def _cached(tmp: Path, cfg: dict) -> dict:
    return dict(jconf.merge(cfg, {"data": {"cache": str(tmp / "cache.safetensors")}}))


def _mesh(cfg: dict, data=1, fsdp=1, tensor=1) -> dict:
    return dict(jconf.merge(cfg, {"trainer": {"mesh": {"data": data, "fsdp": fsdp,
                                                        "tensor": tensor}}}))


def _single(cfg: dict, run_dir: Path, draws=None, steps=STEPS, resume=None, save=True):
    """The port's single process on ``cfg`` without its mesh, with the
    worker's ``draws``: (trainer, losses)."""
    cfg = dict(cfg, trainer={k: v for k, v in cfg["trainer"].items() if k != "mesh"})
    tr = TTrainer(tconf.merge(tconf.default(), tconf.Config(cfg)), run_dir, device="cpu")
    if resume is not None:
        tr.resume(resume)
    losses = []
    real = tr._log
    tr._log = lambda m, s: (losses.append((s, m["train_loss"])), real(m, s))
    if steps:
        tr.fit(max_steps_override=tr.global_step + steps, final_save=save,
               draws_fn=draws_of(tr.spec, draws))
    elif save:
        tr._save(tr.epoch_cursor, {})
    return tr, losses


SHAPES = {"unet.a.weight": (64, 32), "unet.b.weight": (16, 16), "unet.b.bias": (16,),
          "unet.c.weight": (40, 8), "unet.c.bias": (40,), "unet.d.weight": (12,),
          "unet.e.weight": (24, 24), "condition_model.encoder.f.weight": (24, 32),
          "condition_model.encoder.f.bias": (24,)}
LABELS = {k: "g1" if k.startswith("condition_model") else "g0" for k in SHAPES}
OPTIMIZER_JOBS = {
    "adamw_xla": ({"name": "adamw"}, "float32", "bfloat16"),
    "adamw_bf16": ({"name": "adamw", "master_dtype": "bf16", "moment_dtype": "bf16"},
                   "bfloat16", "bfloat16"),
    "adamw8bit": ({"name": "bitsandbytes.optim.AdamW8bit"}, "float32", "bfloat16"),
    "prodigy": ({"name": "prodigy", "params": {"lr": 1.0}}, "float32", "bfloat16"),
    "adafactor": ({"name": "adafactor"}, "float32", "bfloat16"),
}


def _optimizer_config(name: str) -> dict:
    opt, _, _ = OPTIMIZER_JOBS[name]
    return {"optimizer": dict({"params": {"lr": 1e-2}, "lr_scale": {"enabled": False}},
                              **opt),
            "trainer": {"mesh": {"fsdp": 2}, "pack_min_size": 1024}}


def _optimizer_job(name: str, tmp: Path) -> dict:
    _, master, grad = OPTIMIZER_JOBS[name]
    return dict(kind="optimizer", out=str(tmp / "out" / f"opt_{name}"), steps=3,
                config=_optimizer_config(name), master_dtype=master, grad_dtype=grad,
                shapes={k: list(v) for k, v in SHAPES.items()}, labels=LABELS)


def _jax_run(tmp: Path, cfg: dict, mp):
    """The JAX Trainer on a (2,1,2) mesh of 4 of its CPU devices for 3
    steps; its draws (per step, for the port), masters, moments and losses
    are stored."""
    jcfg = jconf.merge(jconf.default(), cfg)
    mp.setattr(jtrainer_mod, "mesh_from_config",
               lambda _: jmesh.make_mesh(2, 1, 2, devices=jax.devices()[:4]))
    jtr = JTrainer(jcfg, tmp / "jax")
    losses = []
    real = jtr._log
    jtr._log = lambda m, s: (losses.append((s, float(m["train_loss"]))), real(m, s))
    rng0 = np.asarray(jtr.state.rng)
    draws = {}
    for step in range(STEPS):
        d = jax_draws(jax.random.fold_in(rng0, step), jtr.spec, LATENTS)
        draws[f"{step}.noise"], draws[f"{step}.timesteps"] = d.noise, d.timesteps
    save_state_dict(draws, tmp / "jax_draws.safetensors")
    jtr.fit(max_steps_override=STEPS)
    tensors = {f"m.{k}": torch.from_numpy(np.asarray(v, np.float32))
               for k, v in jtr.natural_trainable().items()}
    numbers: dict = {}
    _flatten(opt_state_from_jax(jtr.state.opt_state, device="cpu"), "o", tensors, numbers)
    save_state_dict(tensors, tmp / "jax_state.safetensors")
    (tmp / "jax_losses.json").write_text(json.dumps(losses))


def _cache_job(tmp: Path, base: dict) -> dict:
    """``cli.cache`` on 2 ranks with batch 1, each rank's latent noise the
    JAX single-process run's draw for the same image."""
    cfg = dict(base, seed=5, data=dict(base["data"], cache=str(tmp / "jax_cache.safetensors")))
    (tmp / "jax_cache.yaml").write_text(json.dumps(cfg))
    args = ["--config", str(tmp / "jax_cache.yaml"), "--batch-size", "1", "--aug-group-size", "1"]
    result = CliRunner().invoke(jcache.main, args)
    assert result.exit_code == 0, result.output or repr(result.exception)
    # JAX's draws in its batch order (its key split once per batch)
    tcfg = tconf.merge(tconf.default(), tconf.Config(cfg))
    ds = tpipeline.get_dataset(tcfg, use_cache=False)

    def order(world, rank):
        sampler = tpipeline.get_sampler(ds, tcfg, world, rank)
        target = -(-len(ds) // world)   # batch 1: the largest shard
        pipe = tpipeline.DataPipeline(ds, tcache._PaddedSampler(sampler, target), 1,
                                      num_workers=1)
        return [int(b["ids"][0]) for b in pipe]

    key = jax.random.PRNGKey(5)
    by_id = {}
    for id_ in order(1, 0):
        key, sub = jax.random.split(key)
        n = jax.random.normal(sub, (1, RES // 2, RES // 2, 4), np.float32)
        by_id[id_] = torch.from_numpy(np.asarray(n).transpose(0, 3, 1, 2).copy())
    noise = {f"{r}.{i}": by_id[id_] for r in range(2) for i, id_ in enumerate(order(2, r))}
    save_state_dict(noise, tmp / "cache_noise.safetensors")
    (tmp / "port_cache.yaml").write_text(json.dumps(
        dict(cfg, data=dict(cfg["data"], cache=str(tmp / "port_cache.safetensors")))))
    return dict(kind="cache", noise=str(tmp / "cache_noise.safetensors"),
                args=["--config", str(tmp / "port_cache.yaml"), "--batch-size", "1",
                      "--aug-group-size", "1", "--device", "cpu"])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Everything the module's checks read, made once for all xdist workers
    (behind a file lock in their shared temporary root): the JAX run, the
    single-process checkpoint, and both worlds' outputs."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    tmp = root / "torch_parallel"
    with FileLock(str(root / "torch_parallel.lock")):
        if not (tmp / "done").exists():
            _build_worlds(tmp)
            (tmp / "done").write_text("")
    return tmp


def _train(tmp, name, cfg, draws, steps=STEPS, **kw):
    return dict(kind="train", config=cfg, run_dir=str(tmp / "runs" / name), steps=steps,
                out=str(tmp / "out" / name), draws=draws, **kw)


def _setup(tmp: Path) -> dict:
    """The configs and draws of the module."""
    base = _config(tmp, tmp / "model")
    cached = _cached(tmp, base)
    return {"base": base, "cached": cached,
            "lora": dict(cached, optim_target="lora_no-te"),
            "bf16": dict(jconf.merge(cached, {"trainer": {"precision": "bf16"}})),
            "accum": dict(jconf.merge(cached, {"trainer": {"accumulate_grad_batches": 2}})),
            "sd3": _config(tmp, tmp / "sd3"),
            "file": {"file": str(tmp / "jax_draws.safetensors")},
            "seeded": {"shape": [BATCH, 4, RES // 2, RES // 2], "seed": 1, "uncached": True},
            "sd3_seeded": {"shape": [BATCH, 4, RES // 2, RES // 2], "seed": 2,
                           "uncached": True},
            "cached_seeded": {"shape": [BATCH, 4, RES // 2, RES // 2], "seed": 4,
                              "uncached": False}}


def _build_worlds(tmp: Path) -> None:
    tmp.mkdir(parents=True, exist_ok=True)
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    make_image_dataset(tmp, n=IMAGES)
    sd3, _ = tiny_sd3_dir(tmp / "sd3", models=tiny_sd3_models(vocab_size=640), with_t5=False)
    write_vocab(sd3 / "tokenizer")
    c = _setup(tmp)
    (tmp / "cache.yaml").write_text(json.dumps(c["cached"]))
    result = CliRunner().invoke(tcache.main, ["--config", str(tmp / "cache.yaml"), "--batch-size",
                                              "8", "--aug-group-size", "1", "--device", "cpu"])
    assert result.exit_code == 0, result.output or repr(result.exception)
    with pytest.MonkeyPatch.context() as mp:
        _jax_run(tmp, _mesh(c["cached"], 2, 1, 2), mp)
    # the single process on the cached batches and JAX's draws: the state the
    # cached worlds are held against, and the checkpoint world 2 resumes
    tr, losses = _single(c["cached"], tmp / "runs" / "single", c["file"])
    save_state_dict(state_tensors(tr.state)[0], tmp / "single_state.safetensors")
    (tmp / "single_losses.json").write_text(json.dumps(losses))
    # the same at bf16 compute, and its initial masters
    tr, losses = _single(c["bf16"], tmp / "runs" / "single_bf16", c["file"], save=False)
    save_state_dict(state_tensors(tr.state)[0], tmp / "bf16_state.safetensors")
    (tmp / "bf16_losses.json").write_text(json.dumps(losses))
    tr, _ = _single(c["bf16"], tmp / "runs" / "initial", steps=0, save=False)
    save_state_dict({k: v for k, v in state_tensors(tr.state)[0].items() if k.startswith("m.")},
                    tmp / "initial_masters.safetensors")
    del tr

    jobs2 = [_train(tmp, "a211", _mesh(c["base"], 2, 1, 1), c["seeded"]),
             _train(tmp, "b121", _mesh(c["cached"], 1, 2, 1), c["file"], save=True),
             _train(tmp, "c112", _mesh(c["cached"], 1, 1, 2), c["file"], save=True),
             _train(tmp, "d_lora", _mesh(c["lora"], 1, 1, 2), c["file"]),
             _train(tmp, "f_bf16", _mesh(c["bf16"], 1, 2, 1), c["file"]),
             _train(tmp, "f_bf16_tp", _mesh(c["bf16"], 1, 1, 2), c["file"]),
             _train(tmp, "f_bf16_skip_dp", _mesh(c["bf16"], 1, 2, 1), c["file"],
                    fault="skip_dp"),
             _train(tmp, "f_bf16_tp_skip_sum", _mesh(c["bf16"], 1, 1, 2), c["file"],
                    fault="skip_tensor_sum"),
             _train(tmp, "i_accum", _mesh(c["accum"], 1, 2, 1), c["cached_seeded"], steps=4),
             _train(tmp, "e_sd3", _mesh(c["sd3"], 1, 1, 2), c["sd3_seeded"], steps=2),
             _train(tmp, "g_resume", _mesh(c["cached"], 1, 2, 1), None, steps=0, save=True,
                    resume=str(tmp / "runs" / "single" / "epoch=1-step=3.safetensors")),
             _train(tmp, "h_jax_resume", _mesh(c["cached"], 1, 2, 1), None, steps=0, save=True,
                    resume=str(tmp / "jax" / "epoch=1-step=3.safetensors"))]
    jobs2 += [_optimizer_job(name, tmp) for name in OPTIMIZER_JOBS]
    jobs2.append(_cache_job(tmp, c["base"]))
    wait2 = start_world(2, jobs2, tmp)
    wait4 = start_world(4, [_train(tmp, "w212", _mesh(c["cached"], 2, 1, 2), c["file"])], tmp)
    wait2()
    wait4()


def _world_state(out: Path, n: int = 2) -> tuple[dict, list[dict]]:
    """(every rank's tensors merged, each rank's info)."""
    merged, infos = {}, []
    for r in range(n):
        merged.update(load_state_dict(out / f"rank{r}.safetensors"))
        infos.append(json.loads((out / f"rank{r}.json").read_text()))
    return merged, infos


def _check_masters(got: dict, want: dict, lr: float = LR, steps: int = STEPS):
    """fp32 masters of two runs of Adam steps: within 1e-4 of each tensor's
    largest entry in all but 1e-3 of the elements; the rest (a gradient near
    zero whose sign differs between two sums) within 2 lr per step."""
    far, total = 0, 0
    for k in want:
        g, w = to_np(got[k]).astype(np.float64), to_np(want[k]).astype(np.float64)
        d = np.abs(g - w)
        close = 1e-4 * np.abs(w).max()
        assert (d <= close + 2 * lr * steps).all(), k
        far += int((d > close).sum())
        total += d.size
    assert far <= 1e-3 * total, f"{far} of {total} masters beyond the close bound"


def _rel(a, b) -> float:
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_state(merged: dict, want: dict, steps: int = STEPS):
    """Masters by ``_check_masters``; first moments within 1e-4 and second
    moments within 1e-3 of each tensor's largest entry."""
    _check_masters({k[2:]: v for k, v in merged.items() if k.startswith("m.")},
                   {k[2:]: v for k, v in want.items() if k.startswith("m.")}, steps=steps)
    for k, v in want.items():
        if k.startswith("o.") and (".mu." in k or ".nu." in k):
            assert _rel(merged[k], v) <= (1e-4 if ".mu." in k else 1e-3), k


def _compare_to_single(tmp, name, single, n=2, steps=STEPS):
    """World ``name``'s losses and state against the single process's
    ``(state tensors, losses)``; returns the ranks' infos."""
    want, losses = single
    merged, infos = _world_state(tmp / "out" / name, n)
    data = infos[0]["mesh"][0]
    owners = [k for info in infos for k in info["owned"]]
    masters = [k[2:] for k in want if k.startswith("m.")]
    assert sorted(owners) == sorted(masters * data)   # one owner in each data replica
    for info in infos:
        assert [s for s, _ in info["losses"]] == [s for s, _ in losses]
        for (_, g), (_, w) in zip(info["losses"], losses):
            assert abs(g - w) <= 1e-5 * abs(w), (info["losses"], losses)
    _check_state(merged, want, steps)
    return infos


def _cached_single(tmp: Path) -> tuple[dict, list]:
    """The single cached run's state tensors and losses (``_build_worlds``)."""
    return (load_state_dict(tmp / "single_state.safetensors"),
            [tuple(x) for x in json.loads((tmp / "single_losses.json").read_text())])


def test_data_parallel_uncached_matches_single_process(worlds):
    """(2,1,1): each rank decodes 4 of the 8 rows, which the VAE and CLIP
    encode there; the gradients are averaged; both ranks hold every master."""
    c = _setup(worlds)
    tr, losses = _single(c["base"], worlds / "runs" / "single_a", c["seeded"], save=False)
    infos = _compare_to_single(worlds, "a211", (state_tensors(tr.state)[0], losses))
    assert [info["rows"] for info in infos] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("name,mesh", [("b121", [1, 2, 1]), ("c112", [1, 1, 2])])
def test_fsdp_and_tensor_match_single_process(worlds, name, mesh):
    """(1,2,1): the rows split, the masters and moments split by owner;
    (1,1,2): the rows shared, the heads and feed-forward hiddens split, the
    masters split by owner. Each rank's compute copies are every master's."""
    single = _cached_single(worlds)
    infos = _compare_to_single(worlds, name, single)
    assert [info["mesh"] for info in infos] == [mesh, mesh]
    n_masters = sum(k.startswith("m.") for k in single[0])
    assert all(0 < len(info["owned"]) < n_masters for info in infos)
    merged, _ = _world_state(worlds / "out" / name)
    for k, v in merged.items():
        if k.startswith("c."):   # the broadcast compute copy is the owner's master
            assert torch.equal(v, merged["m." + k[2:]]), k


def test_data_and_tensor_on_four_ranks_match_single_process_and_jax(worlds):
    """(2,1,2) on 4 ranks against the port's single process and against the
    JAX Trainer's step on its own (2,1,2) mesh, with JAX's draws."""
    infos = _compare_to_single(worlds, "w212", _cached_single(worlds), n=4)
    assert [info["rows"] for info in infos] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2
    merged, _ = _world_state(worlds / "out" / "w212", 4)
    jax_state = load_state_dict(worlds / "jax_state.safetensors")
    jlosses = json.loads((worlds / "jax_losses.json").read_text())
    for (_, g), (_, w) in zip(infos[0]["losses"], jlosses):
        assert abs(g - w) <= 1e-5 * abs(w), (infos[0]["losses"], jlosses)
    _check_state(merged, jax_state)


# bf16 compute, against the single process: the share of masters beyond the
# close bound (each within 2 lr per step) and the update deltas' relative L2
# error. Sound worlds read 1.7e-2 / 4.0e-2 and 1.3e-2 / 5.9e-2 ((1,2,1) /
# (1,1,2)); the planted faults 0.82 / 0.25 and 0.65 / 0.31 (skipped dp
# all-reduce / skipped tensor sum)
BF16_FAR_SHARE, BF16_DELTA_TOL = 5e-2, 1e-1


def _bf16_reading(worlds: Path, name: str) -> dict:
    """World ``name`` at bf16 compute against the single process: the share
    of masters beyond 1e-4 of their tensor's largest entry, the largest
    excess over that plus 2 lr per step, the update deltas' (from the
    initial masters) relative L2 error, and the losses' largest relative
    error."""
    want = load_state_dict(worlds / "bf16_state.safetensors")
    losses = json.loads((worlds / "bf16_losses.json").read_text())
    init = load_state_dict(worlds / "initial_masters.safetensors")
    merged, infos = _world_state(worlds / "out" / name)
    far, total, excess, num, den = 0, 0, -np.inf, 0.0, 0.0
    for k, v in want.items():
        if k.startswith("m."):
            g, w = to_np(merged[k]).astype(np.float64), to_np(v).astype(np.float64)
            d = np.abs(g - w)
            close = 1e-4 * np.abs(w).max()
            excess = max(excess, float((d - close - 2 * LR * STEPS).max()))
            far += int((d > close).sum())
            total += d.size
            num += float(np.square(g - w).sum())
            den += float(np.square(w - to_np(init[k]).astype(np.float64)).sum())
    loss = max(abs(g - w) / abs(w) for (_, g), (_, w) in zip(infos[0]["losses"], losses))
    return {"far_share": far / total, "max_excess": excess,
            "delta_rel_l2": (num / den) ** 0.5, "loss": loss}


@pytest.mark.parametrize("name", ["f_bf16", "f_bf16_tp"])
def test_bf16_compute_world_within_its_bound(worlds, name):
    """(1,2,1) and (1,1,2) at bf16 compute (the default precision), against
    the single process: each rank's bf16 gradients of its rows are summed in
    fp32 and rounded once, where one process rounds the whole batch's once
    (and tensor 2 sums its row-parallel outputs in fp32 before one
    rounding), so Adam's sign-like first step flips more elements. Losses
    within 1e-2 relative; every master within 1e-4 of its tensor's largest
    entry plus 2 lr per step, at most BF16_FAR_SHARE of them beyond the
    first term; the update deltas within BF16_DELTA_TOL relative L2."""
    r = _bf16_reading(worlds, name)
    assert r["loss"] <= 1e-2 and r["max_excess"] <= 0, r
    assert 0 < r["far_share"] <= BF16_FAR_SHARE and r["delta_rel_l2"] <= BF16_DELTA_TOL, r


@pytest.mark.parametrize("name", ["f_bf16_skip_dp", "f_bf16_tp_skip_sum"])
def test_bf16_bound_rejects_a_faulty_world(worlds, name):
    """The negative controls of the bound above: (1,2,1) with the ranks'
    data-parallel all-reduce skipped (each owner steps on its own 4 rows'
    mean) and (1,1,2) with the tensor group's sum of the partial gradients
    skipped both fail it, by the share of masters beyond the close bound
    and by the update deltas."""
    r = _bf16_reading(worlds, name)
    assert r["far_share"] > BF16_FAR_SHARE and r["delta_rel_l2"] > BF16_DELTA_TOL, r


def test_accumulation_under_owners_broadcasts_after_each_update(worlds):
    """(1,2,1) with 2 micro-steps per update, 4 micro-steps: the world
    matches the single process, and each rank broadcasts its compute copies
    after the two updates only."""
    c = _setup(worlds)
    tr, losses = _single(c["accum"], worlds / "runs" / "single_accum", c["cached_seeded"],
                         steps=4, save=False)
    infos = _compare_to_single(worlds, "i_accum", (state_tensors(tr.state)[0], losses), steps=2)
    assert [info["refreshed"] for info in infos] == [[1, 3], [1, 3]]


def test_lora_with_tensor_parallel_matches_single_process(worlds):
    """LoRA on every attention and feed-forward linear under tensor 2: the
    GEGLU projection's rows split as value and gate halves, the factors read
    under the shard and their gradients summed over the tensor group."""
    c = _setup(worlds)
    tr, losses = _single(c["lora"], worlds / "runs" / "single_lora", c["file"], save=False)
    assert any(k.endswith("ff.net.0.proj.lora_B") for k in tr.state.trainable)
    _compare_to_single(worlds, "d_lora", (state_tensors(tr.state)[0], losses))


def test_sd3_mmdit_with_tensor_parallel_matches_single_process(worlds):
    """The tiny MMDiT under tensor 2 (joint attention at H/2 over both
    streams, the context stream's projections split too), uncached."""
    c = _setup(worlds)
    tr, losses = _single(c["sd3"], worlds / "runs" / "single_sd3", c["sd3_seeded"], steps=2,
                         save=False)
    _compare_to_single(worlds, "e_sd3", (state_tensors(tr.state)[0], losses), steps=2)


def _single_optimizer(name: str):
    cfg = tconf.merge(tconf.default(), tconf.Config(_optimizer_config(name)))
    _, master, grad = OPTIMIZER_JOBS[name]
    dtype, grad_dtype = getattr(torch, master), getattr(torch, grad)
    gen = torch.Generator().manual_seed(11)
    masters = {k: torch.randn(s, generator=gen).to(dtype) for k, s in sorted(SHAPES.items())}
    pack = jax_pack_spec(cfg, {k: v.float() for k, v in masters.items()}, LABELS)
    tx, _ = build_optimizer(cfg, LABELS, {g: {} for g in sorted(set(LABELS.values()))}, 10, 1,
                            pack_spec=pack)
    state = tx.init(masters)
    for step in range(3):
        state = tx.update_and_apply(seeded_grads(SHAPES, grad_dtype, step), state, masters,
                                    step)
    tensors = {f"m.{k}": v for k, v in masters.items()}
    numbers: dict = {}
    _flatten(state, "o", tensors, numbers)
    return tensors, numbers, pack


@pytest.mark.parametrize("name", ["adamw_xla", "adamw_bf16", "adamw8bit", "prodigy",
                                  "adafactor"])
def test_fsdp_owner_updates_match_single_process(worlds, name, monkeypatch):
    """3 updates of the same gradients: each owner's leaves and state against
    the single process's. AdamW (both roundings), AdamW8bit and Adafactor
    with packed slabs (one owner per slab) bit for bit; Prodigy's group-wide
    sums add the owners' partial sums in another order (difference (r)):
    within 1e-5 of each tensor's largest entry."""
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "256")
    want, numbers, pack = _single_optimizer(name)
    merged, infos = _world_state(worlds / "out" / f"opt_{name}")
    owned = [set(info["owned"]) for info in infos]
    assert owned[0].isdisjoint(owned[1]) and owned[0] | owned[1] == set(SHAPES)
    if pack is not None:
        for _, _, slots in pack.slabs:
            assert len({i for i, o in enumerate(owned) for s in slots if s.key in o}) == 1
    if name == "adafactor":
        assert pack is not None and pack.slabs
    for info in infos:
        assert info["numbers"] == {k: v for k, v in numbers.items() if k in info["numbers"]}
    for k, v in want.items():
        if k not in merged:   # a group-wide entry of a group this rank holds nothing of
            continue
        if name == "prodigy":
            assert _rel(merged[k], v) <= 1e-5, k
        else:
            assert torch.equal(merged[k], v), k
    assert {k for k in want if k.startswith("m.")} <= set(merged)


@pytest.mark.parametrize("name", ["b121", "c112"])
def test_world_checkpoint_equals_single_process_file(worlds, name, tmp_path):
    """The world's gathered checkpoint, resumed by one process and saved
    again at once: the same keys, dtypes, values and metadata in both
    files (the sidecar too)."""
    c = _setup(worlds)
    ckpt = worlds / "runs" / name / "epoch=1-step=3.safetensors"
    _single(c["cached"], tmp_path / "again", resume=ckpt, steps=0)
    again = tmp_path / "again" / "epoch=1-step=3.safetensors"
    for suffix in ("", ".torchstate"):
        a, b = Path(str(ckpt) + suffix), Path(str(again) + suffix)
        ta, tb = load_state_dict(a, "safetensors"), load_state_dict(b, "safetensors")
        assert ta.keys() == tb.keys()
        for k in ta:
            assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
        assert load_metadata(a) == load_metadata(b)


@pytest.mark.parametrize("name,source", [("g_resume", "runs/single/epoch=1-step=3.safetensors"),
                                         ("h_jax_resume", "jax/epoch=1-step=3.safetensors")])
def test_checkpoints_resume_under_world_two(worlds, name, source, tmp_path):
    """A single-process checkpoint and a JAX ``.trainstate`` resumed under
    (1,2,1): each rank holds its own leaves and their moments, and the
    world saves the file a single process saves after the same resume."""
    c = _setup(worlds)
    tr, _ = _single(c["cached"], tmp_path / "single", resume=worlds / source, steps=0)
    want, _ = state_tensors(tr.state)
    merged, infos = _world_state(worlds / "out" / name)
    assert all(info["step"] == STEPS for info in infos)
    for k, v in merged.items():
        if k.startswith(("m.", "o.")):
            assert torch.equal(v, want[k]), k
    assert {k for k in want if k.startswith("m.")} <= set(merged)
    a = worlds / "runs" / name / "epoch=1-step=3.safetensors"
    b = tmp_path / "single" / "epoch=1-step=3.safetensors"
    ta, tb = load_state_dict(a), load_state_dict(b)
    assert ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)
    sa, sb = (load_state_dict(Path(str(f) + ".torchstate"), "safetensors") for f in (a, b))
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_cache_under_two_processes_matches_jax(worlds):
    """``cli.cache`` on 2 ranks: one file, the JAX single-process cache's
    keys and metadata, values within 1e-5 of each tensor's largest entry."""
    want = jstate.load_state_dict(worlds / "jax_cache.safetensors")
    got = load_state_dict(worlds / "port_cache.safetensors")
    assert json.loads(load_metadata(worlds / "port_cache.safetensors")["json"]) == \
        json.loads(jstate.load_metadata(worlds / "jax_cache.safetensors")["json"])
    assert got.keys() == want.keys() and len(got) == 2 * IMAGES
    for k, w in want.items():
        g, w = to_np(got[k]), np.asarray(w)
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
