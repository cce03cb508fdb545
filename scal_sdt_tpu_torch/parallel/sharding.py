"""Data parallelism, owner-sharded optimizer state (fsdp) and the collectives
of the train step, over the flat param dicts of the functional step.

``DistributedDataParallel`` and ``fully_shard`` wrap ``nn.Module``s; the
port's step is a function of flat dicts, so its parallelism is written as
collectives on those dicts (``Parallel``):

* **rows.** Each rank runs the host's sampler and decodes its own rows of
  every host batch (``Mesh.host_rows``: split over the host's data x fsdp
  ranks, shared by tensor peers). The step draws its noise, timesteps and
  latent noise for the whole batch from one generator seeded alike on every
  rank and takes the rank's rows (``Rows``), so a world of N ranks draws
  what one process draws for the same global batch.
* **gradients.** After the backward, ``reduce_grads`` sums the gradients
  over the dp group in a few flat fp32 buckets (``BUCKET_BYTES``) and
  divides by its size, then rounds once to the gradient's dtype: the JAX
  step's reduction on its CPU mesh, which XLA promotes from bf16 to an fp32
  all-reduce and rounds to bf16 after. The leaves ``tensor_sum`` names
  (partial on each tensor rank) are first summed over the tensor group in
  the same fp32 buffer.
* **owners.** Every trainable leaf has one owner among the fsdp x tensor
  ranks of a data coordinate (``assign_owners``: sorted keys, balanced by
  bytes, the blocks that must stay whole, Adafactor's packed slabs and
  stacks, never split). Only the owner holds its master, optimizer state
  and EMA shadow, and the grouped optimizer kernels run over each group's
  owned leaves with the group's hyperparameters and salts, so for the same
  reduced gradient an owner's update is the single-process update bit for
  bit. ``refresh_compute`` then casts each owner's new masters into the
  compute-dtype copy and broadcasts it to the group in flat buckets. The
  compute copy and the frozen weights stay replicated (the JAX package's
  GSPMD shards them too: ROADMAP difference (z)).

gloo stages a CUDA tensor's all-reduce and broadcast through host memory:
two ranks that share one card over gloo measure correctness and memory, not
multi-GPU speed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh
from .tensor import TensorParallel, all_reduce_sum

# the largest flat bucket of one collective, in bytes of its fp32 buffer
BUCKET_BYTES = 256 << 20


def assign_owners(sizes: dict[str, int], n: int,
                  units: Iterable[Iterable[str]] = ()) -> dict[str, int]:
    """key -> owner index in [0, n): ``sizes`` (bytes per key), ``units``
    (keys that must share an owner). Blocks in descending bytes (ties by
    name) each go to the least loaded owner (ties to the lowest index)."""
    unit_of: dict[str, tuple[str, ...]] = {}
    for unit in units:
        members = tuple(sorted(k for k in unit if k in sizes))
        for k in members:
            unit_of[k] = members
    blocks = sorted({unit_of.get(k, (k,)) for k in sizes},
                    key=lambda b: (-sum(sizes[k] for k in b), b))
    load = [0] * max(n, 1)
    owner: dict[str, int] = {}
    for block in blocks:
        i = min(range(len(load)), key=lambda j: (load[j], j))
        for k in block:
            owner[k] = i
        load[i] += sum(sizes[k] for k in block)
    return owner


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rank's rows of the global batch: ``index`` (global positions,
    in the rank's batch order) of ``total``."""
    index: torch.Tensor
    total: int

    def take(self, t: torch.Tensor) -> torch.Tensor:
        return t.index_select(0, self.index.to(t.device))


def _buckets(keys: list[str], numel: dict[str, int], limit: int) -> list[list[str]]:
    out: list[list[str]] = []
    size = 0
    for k in keys:
        if not out or (size + numel[k] > limit and out[-1]):
            out.append([])
            size = 0
        out[-1].append(k)
        size += numel[k]
    return out


class Parallel:
    """The collectives of one rank's train step (see the module doc)."""

    def __init__(self, mesh: Mesh, shapes: dict[str, tuple[tuple[int, ...], torch.dtype]],
                 rows: Optional[Rows] = None, tp: Optional[TensorParallel] = None,
                 tensor_sum: Iterable[str] = (), units: Iterable[Iterable[str]] = ()):
        """``shapes``: every trainable key -> (shape, master dtype)."""
        self.mesh, self.rows, self.tp = mesh, rows, tp
        self.shapes = dict(shapes)
        self.numel = {k: _numel(s) for k, (s, _) in self.shapes.items()}
        sizes = {k: self.numel[k] * dt.itemsize for k, (_, dt) in self.shapes.items()}
        self.owner = assign_owners(sizes, mesh.model_size, units)
        self.tensor_sum = set(tensor_sum) & set(self.shapes)
        keys = sorted(self.shapes)
        limit = BUCKET_BYTES // 4
        summed = [k for k in keys if k in self.tensor_sum]
        rest = [k for k in keys if k not in self.tensor_sum]
        self.grad_buckets = ([(b, True) for b in _buckets(summed, self.numel, limit)]
                             + [(b, False) for b in _buckets(rest, self.numel, limit)])
        self.broadcast_buckets = [
            (i, b) for i in range(mesh.model_size)
            for b in _buckets([k for k in keys if self.owner[k] == i], self.numel, limit)]
        self._buf: Optional[torch.Tensor] = None

    # -- who holds what --------------------------------------------------------------

    @property
    def sharded(self) -> bool:
        """Whether masters are split over owners (fsdp x tensor above one)."""
        return self.mesh.model_size > 1

    def owns(self, key: str) -> bool:
        return self.owner[key] == self.mesh.model_index

    def owned(self, tree: dict) -> dict:
        return {k: v for k, v in tree.items() if k not in self.owner or self.owns(k)}

    # -- the step's collectives -----------------------------------------------------

    def _buffer(self, n: int, device: torch.device) -> torch.Tensor:
        """The first ``n`` entries of the fp32 buffer the gradient buckets
        share (sized for the largest)."""
        if self._buf is None or self._buf.device != device:
            largest = max(sum(self.numel[k] for k in b) for b, _ in self.grad_buckets)
            self._buf = torch.empty(largest, dtype=torch.float32, device=device)
        return self._buf[:n]

    @torch.no_grad()
    def reduce_grads(self, grads: dict[str, torch.Tensor]) -> None:
        """Average ``grads`` over the dp group in place (partial leaves summed
        over the tensor group first)."""
        dp, tensor = self.mesh.group("dp"), self.mesh.group("tensor")
        for keys, summed in self.grad_buckets:
            if dp is None and not (summed and tensor is not None):
                continue
            n = sum(self.numel[k] for k in keys)
            buf = self._buffer(n, grads[keys[0]].device)
            views = list(buf.split([self.numel[k] for k in keys]))
            torch._foreach_copy_(views, [grads[k].reshape(-1) for k in keys])
            if summed and tensor is not None:
                all_reduce_sum(buf, tensor)
            if dp is not None:
                all_reduce_sum(buf, dp)
                buf.div_(buf.new_full((), self.mesh.dp_size))
            torch._foreach_copy_([grads[k] for k in keys],
                                 [v.view(grads[k].shape) for v, k in zip(views, keys)])

    @torch.no_grad()
    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        dp = self.mesh.group("dp")
        if dp is None:
            return loss
        total = all_reduce_sum(loss.detach().float().clone(), dp)
        return total / total.new_full((), self.mesh.dp_size)

    @torch.no_grad()
    def refresh_compute(self, compute: dict[str, torch.Tensor],
                        masters: dict[str, torch.Tensor]) -> None:
        """Each owner casts its masters into ``compute``; then every owner's
        compute copies are broadcast over the model group in flat buckets."""
        keys = sorted(masters)
        torch._foreach_copy_([compute[k] for k in keys], [masters[k] for k in keys])
        group = self.mesh.group("model")
        if group is None:
            return
        me = self.mesh.model_index
        for owner, bucket in self.broadcast_buckets:
            ts = [compute[k] for k in bucket]
            flat = torch.cat([t.reshape(-1) for t in ts]) if owner == me else torch.empty(
                sum(t.numel() for t in ts), dtype=ts[0].dtype, device=ts[0].device)
            dist.broadcast(flat, src=self.mesh.model_rank(owner), group=group)
            if owner != me:
                torch._foreach_copy_(ts, [v.view(t.shape) for v, t in
                                          zip(flat.split([t.numel() for t in ts]), ts)])

    # -- host objects ---------------------------------------------------------------

    def gather(self, tensors: dict) -> Optional[dict]:
        """The union of every rank's ``tensors`` of data coordinate 0, on
        rank 0 (None elsewhere), as host tensors."""
        local = ({k: v.detach().cpu() for k, v in tensors.items()}
                 if self.mesh.coord[0] == 0 else {})
        group = self.mesh.group("cpu")
        if group is None:
            return local
        out = [None] * self.mesh.world if self.mesh.rank == 0 else None
        dist.gather_object(local, out, dst=0, group=group)
        if self.mesh.rank != 0:
            return None
        merged: dict = {}
        for part in out:
            merged.update(part)
        return merged


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
