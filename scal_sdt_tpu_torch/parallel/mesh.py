"""The device mesh over ``torch.distributed`` (port of
``scal_sdt_tpu/parallel/mesh.py``).

One process per card, launched by ``python -m torch.distributed.run``: the
process group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
each process takes ``cuda:LOCAL_RANK``. The backend is NCCL for CUDA and gloo
for the CPU; an explicit ``backend=`` overrides it (two ranks that share one
card need gloo: NCCL refuses two ranks on one device).

The mesh has JAX's three axes and ``make_mesh``'s rules: ``data: null``
takes world / (fsdp * tensor), the product must equal the world size, and
rank ``r`` sits at the (data, fsdp, tensor) coordinate of device ``r`` in
JAX's ``reshape(data, fsdp, tensor)``. ``Mesh`` holds the subgroups each
rank needs:

* ``dp``: the data x fsdp ranks of one tensor coordinate, over which the
  gradients are averaged (the batch's rows are split over them);
* ``tensor``: the tensor peers of one (data, fsdp) coordinate, which share
  rows and split heads (``parallel/tensor.py``);
* ``model``: the fsdp x tensor ranks of one data coordinate, among which
  every trainable leaf has one owner (``parallel/sharding.py``);
* ``cpu``: a gloo group over the world for host objects (checkpoint and
  cache gathers), whatever the backend.

Before the process group, the ranks can share host values through the
store of torchrun's rendezvous (``rendezvous_store``, ``share_from_rank0``):
the train CLI names the run and tunes the batch that way, so no rank holds
a CUDA context or a communicator while the tuner's trials use the cards;
the process group then joins on the same store.

The Megatron suffix lists and ``tp_dim`` / ``tp_param_names`` are the JAX
package's. ``tensor > 1`` across hosts is refused with JAX's message. The
JAX package's active-mesh registry has no counterpart: its attention reads
the mesh to wrap the kernel in a ``shard_map``, while here the models take
the tensor split from their param dict (``parallel/tensor.py``), so
sampling on rank 0 runs the whole model during a sharded run.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

# Megatron-style tensor-parallel rules over the diffusers parameter names.
# Column-parallel (shard the OUT dim, dim 0 of torch (out, in) Linear):
# activations leave sharded on the feature axis — for q/k/v that is the
# fused head axis, for ff.net.0.proj the GEGLU hidden. Row-parallel (shard
# the IN dim): consumes the sharded feature axis, then the all-reduce.
_TP_COL_SUFFIXES = (".to_q.weight", ".to_k.weight", ".to_v.weight",
                    ".ff.net.0.proj.weight",
                    # MMDiT (SD3) context-stream projections + context FF
                    ".add_q_proj.weight", ".add_k_proj.weight",
                    ".add_v_proj.weight", ".ff_context.net.0.proj.weight")
_TP_ROW_SUFFIXES = (".to_out.0.weight", ".ff.net.2.weight",
                    ".to_add_out.weight", ".ff_context.net.2.weight")


def mesh_shape(data: Optional[int], fsdp: int, tensor: int, n: int) -> tuple[int, int, int]:
    """(data, fsdp, tensor) over ``n`` ranks by ``make_mesh``'s rules."""
    fsdp = max(int(fsdp or 1), 1)
    tensor = max(int(tensor or 1), 1)
    if data is None:
        if n % (fsdp * tensor) != 0:
            raise ValueError(f"{n} devices not divisible by fsdp={fsdp}*tensor={tensor}")
        data = n // (fsdp * tensor)
    data = int(data)
    if data * fsdp * tensor != n:
        raise ValueError(f"mesh {data}x{fsdp}x{tensor} != {n} devices")
    return data, fsdp, tensor


def coords(rank: int, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    """Rank -> its (data, fsdp, tensor) coordinate: the position of device
    ``rank`` in ``reshape(data, fsdp, tensor)``."""
    _, f, t = shape
    return rank // (f * t), (rank // t) % f, rank % t


def rank_of(coord: tuple[int, int, int], shape: tuple[int, int, int]) -> int:
    d, f, t = coord
    return (d * shape[1] + f) * shape[2] + t


def tp_dim(name: str, shape: tuple[int, ...], tp: int) -> Optional[int]:
    """Which dim of ``name`` the tensor axis shards, or None if not a TP param.

    Only the 2-D Linear weights of the transformer blocks participate;
    biases stay replicated, LoRA factors stay replicated (rank-r, tiny).
    """
    if tp <= 1 or len(shape) != 2:
        return None
    if name.endswith(_TP_COL_SUFFIXES) and shape[0] % tp == 0:
        return 0
    if name.endswith(_TP_ROW_SUFFIXES) and shape[1] % tp == 0:
        return 1
    return None


def tp_param_names(shapes: dict, tp: int) -> set[str]:
    """Names that get a tensor-axis sharding (for pack exclusion)."""
    return {k for k, v in shapes.items()
            if tp_dim(k, tuple(v.shape), tp) is not None}


# --- the process group ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchEnv:
    """torchrun's view of this process."""
    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1

    @property
    def hosts(self) -> int:
        return max(self.world // max(self.local_world, 1), 1)

    @property
    def host(self) -> int:
        return self.rank // max(self.local_world, 1)

    @classmethod
    def from_environ(cls) -> "LaunchEnv":
        world = int(os.environ.get("WORLD_SIZE", "1"))
        return cls(rank=int(os.environ.get("RANK", "0")), world=world,
                   local_rank=int(os.environ.get("LOCAL_RANK", "0")),
                   local_world=int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def process_device(device: str | torch.device, env: LaunchEnv) -> torch.device:
    """The process's device: ``cuda`` becomes ``cuda:LOCAL_RANK``; an
    explicit index (``cuda:0``) is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", env.local_rank)
    return dev


def launched() -> bool:
    """Whether torchrun started this process (its world may hold one rank)."""
    return "TORCHELASTIC_RUN_ID" in os.environ


# torch.distributed's default wait of a store and a process group
STORE_TIMEOUT = timedelta(minutes=30)


def rendezvous_store(env: Optional[LaunchEnv] = None,
                     timeout: timedelta = STORE_TIMEOUT) -> Optional[dist.Store]:
    """The key-value store of torchrun's rendezvous (``env://``: rank 0's
    TCP store, or the agent's), reached as ``init_process_group`` would
    reach it but without a process group: no device is touched and no
    communicator made. None alone in a world, where nothing is shared."""
    env = env or LaunchEnv.from_environ()
    if env.world == 1:
        return None
    store, _, _ = next(dist.rendezvous("env://", env.rank, env.world, timeout=timeout))
    store.set_timeout(timeout)
    return store


def share_from_rank0(store: Optional[dist.Store], env: LaunchEnv, key: str,
                     make: Callable[[], Any], wait: timedelta = STORE_TIMEOUT) -> Any:
    """``make()`` on rank 0, its (JSON) value on every rank through
    ``store`` (``rendezvous_store``'s), and ``make()`` itself alone in a
    world. An exception in rank 0's ``make`` re-raises there and, named, on
    every other rank; the others wait up to ``wait`` for rank 0."""
    if env.world == 1:
        return make()
    if store is None:
        raise RuntimeError(f"sharing {key!r} over {env.world} ranks needs the rendezvous store")
    key = f"scal_sdt/{key}"
    if env.rank == 0:
        try:
            value = make()
        except BaseException as e:
            store.set(key, json.dumps({"error": f"{type(e).__name__}: {e}"}))
            raise
        store.set(key, json.dumps({"value": value}))
        return value
    store.wait([key], wait)
    got = json.loads(store.get(key))
    if "error" in got:
        raise RuntimeError(f"rank 0 failed to produce {key}: {got['error']}")
    return got["value"]


def init_process_group(device: torch.device, backend: Optional[str] = None,
                       env: Optional[LaunchEnv] = None,
                       store: Optional[dist.Store] = None) -> LaunchEnv:
    """Join the process group torchrun describes (a no-op for a process
    torchrun did not start, alone in its world, or for an initialized
    group), through ``store`` when given (``rendezvous_store``'s) or
    ``env://``. ``backend`` overrides the device's default and is
    printed."""
    env = env or LaunchEnv.from_environ()
    if (env.world > 1 or launched()) and not dist.is_initialized():
        chosen = backend or default_backend(device)
        if backend:
            print(f"[rank {env.rank}] torch.distributed backend={backend} (given explicitly)",
                  flush=True)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if store is not None:
            dist.init_process_group(chosen, store=store, rank=env.rank, world_size=env.world)
        else:
            dist.init_process_group(chosen, init_method="env://", rank=env.rank,
                                    world_size=env.world)
    return env


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, fsdp, tensor) mesh and its groups
    (None where a group would hold this rank alone)."""
    shape: tuple[int, int, int]
    rank: int = 0
    env: LaunchEnv = LaunchEnv()
    backend: Optional[str] = None
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    @property
    def coord(self) -> tuple[int, int, int]:
        return coords(self.rank, self.shape)

    @property
    def tensor(self) -> int:
        return self.shape[2]

    @property
    def tensor_index(self) -> int:
        return self.coord[2]

    @property
    def dp_size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def dp_index(self) -> int:
        d, f, _ = self.coord
        return d * self.shape[1] + f

    @property
    def model_size(self) -> int:
        return self.shape[1] * self.shape[2]

    @property
    def model_index(self) -> int:
        _, f, t = self.coord
        return f * self.shape[2] + t

    def model_rank(self, index: int) -> int:
        """Global rank of the member ``index`` of this rank's model group."""
        return self.coord[0] * self.model_size + index

    def group(self, name: str):
        return self.groups.get(name)

    def host_rows(self, batch_size: int) -> tuple[int, int]:
        """[lo, hi): this rank's rows of its host's batch of ``batch_size``.
        The host's data x fsdp ranks split the rows; tensor peers share them."""
        slots = host_slots(batch_size, self.env, self.tensor)
        per = batch_size // slots
        slot = (self.env.local_rank // self.tensor) % slots
        return slot * per, (slot + 1) * per


def host_slots(batch_size: int, env: LaunchEnv, tensor: int) -> int:
    """The data-parallel ranks of a host, which split its batch."""
    slots = max(env.local_world // tensor, 1)
    if int(batch_size) % slots != 0:
        raise ValueError(
            f"batch_size {batch_size} is not divisible by the {slots} data-parallel "
            f"ranks of a host ({env.local_world} processes per host / tensor "
            f"{tensor}): each rank decodes batch_size / {slots} rows")
    return slots


def _new_groups(shape: tuple[int, int, int], rank: int, backend: Optional[str]) -> dict:
    """Every subgroup, created in the same order on every rank (as
    ``dist.new_group`` needs); returns this rank's."""
    data, fsdp, tensor = shape
    world = data * fsdp * tensor
    mine: dict = {}

    def make(name: str, members: list[int]):
        if len(members) == 1:
            return
        group = dist.new_group(members, backend=backend)
        if rank in members:
            mine[name] = group

    for t in range(tensor):
        make("dp", [rank_of((d, f, t), shape) for d in range(data) for f in range(fsdp)])
    for d in range(data):
        for f in range(fsdp):
            make("tensor", [rank_of((d, f, t), shape) for t in range(tensor)])
    for d in range(data):
        make("model", [rank_of((d, f, t), shape) for f in range(fsdp) for t in range(tensor)])
    if world > 1:
        mine["world"] = dist.group.WORLD
        mine["cpu"] = (dist.group.WORLD if dist.get_backend() == "gloo"
                       else dist.new_group(list(range(world)), backend="gloo"))
    return mine


def check_mesh(trainer_config, env: LaunchEnv,
               batch_size: Optional[int] = None) -> tuple[int, int, int]:
    """The (data, fsdp, tensor) shape of ``trainer.mesh`` over the launched
    world, refusing what cannot run before any process group exists: a
    tensor axis across hosts, a product that is not the world size, and a
    ``batch_size`` the host's data-parallel ranks do not divide."""
    mesh_conf = trainer_config.get("mesh", {}) or {}
    tensor = mesh_conf.get("tensor", 1) or 1
    if int(tensor) > 1 and env.hosts > 1:
        # the per-host data pipeline shards batches by host over the data
        # axis only; a tensor axis spanning hosts would desync that mapping
        raise NotImplementedError(
            "trainer.mesh.tensor > 1 is single-host (all tensor-parallel "
            "peers must share a host's data shard); use data/fsdp across "
            "hosts")
    shape = mesh_shape(mesh_conf.get("data"), mesh_conf.get("fsdp", 1) or 1, tensor, env.world)
    if batch_size is not None and env.world > 1:
        host_slots(batch_size, env, shape[2])
    return shape


def mesh_from_config(trainer_config, env: Optional[LaunchEnv] = None) -> Mesh:
    """The mesh of ``trainer.mesh`` over the launched world (an initialized
    process group when the world holds more than one rank)."""
    env = env or LaunchEnv.from_environ()
    shape = check_mesh(trainer_config, env)
    if env.world > 1 and (not dist.is_initialized() or dist.get_world_size() != env.world):
        raise RuntimeError(f"WORLD_SIZE={env.world}: initialize the process group first "
                           "(parallel.mesh.init_process_group)")
    backend = dist.get_backend() if env.world > 1 else None
    return Mesh(shape=shape, rank=env.rank, env=env, backend=backend,
                groups=_new_groups(shape, env.rank, None) if env.world > 1 else {})
