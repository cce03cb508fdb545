"""Megatron tensor parallelism over the transformer blocks' linears.

A tensor rank computes ``H / tensor`` heads of every attention and its slice
of every feed-forward hidden. ``tp_view`` gives the denoiser's param dict the
rank's view: column-parallel weights (``mesh._TP_COL_SUFFIXES``: q/k/v, the
first feed-forward projection, MMDiT's context projections) keep the rows of
the rank's heads, with their biases; row-parallel weights (``to_out.0``,
``ff.net.2``, ``to_add_out``, ``ff_context.net.2``) keep the matching
columns. The slices are views of the replicated weights, so the gradient of
a trainable leaf holds the rank's slice and zeros elsewhere.

The UNet's GEGLU projection (``ff.net.0.proj``, rows ``[value; gate]``,
which ``models/unet.py`` chunks in two) gives each rank its slice of *both*
halves, so the value and gate of one hidden unit stay on one rank; a plain
GELU projection (MMDiT's) is sliced contiguously.

``linear`` (``models/functional.py``) reads the ``TENSOR_PARALLEL`` entry of
the dict: a column-parallel layer takes its input through ``copy_in``
(identity forward, all-reduce of the input's gradient backward); a
row-parallel layer sums its partial output over the tensor group
(``reduce_out``: all-reduce forward, identity backward) and adds its bias
once, after the sum. Both sums run in fp32 and round once.

LoRA factors on those layers stay replicated and are read under the shard:
B's rows under a column-parallel weight, A's columns under a row-parallel
one. Their gradients, like those of the sliced weights and column biases,
are partial on each rank; ``tensor_sum_keys`` names them, and the train step
sums them over the tensor group before the update. Every other gradient is
already whole on each tensor rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import tp_dim

TENSOR_PARALLEL = "__tensor_parallel__"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place."""
    dist.all_reduce(x, group=group)
    return x


class _CopyIn(torch.autograd.Function):
    """Identity forward; the input's gradient summed over the tensor group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce_sum(grad.float().contiguous(), ctx.group)
        return total.to(grad.dtype), None


class _ReduceOut(torch.autograd.Function):
    """The partial outputs summed over the tensor group (fp32, ``x``'s dtype
    comes back in fp32); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return all_reduce_sum(x.float().contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The tensor group of a rank and the layers it splits (component-
    relative name -> 'col' | 'row')."""
    size: int
    index: int
    group: object
    layers: dict

    def kind(self, layer: str) -> Optional[str]:
        return self.layers.get(layer)

    def heads(self, layer: str, num_heads: int) -> int:
        """The rank's head count for an attention whose query projection is
        ``layer``."""
        if self.layers.get(layer) != "col":
            return num_heads
        if num_heads % self.size:
            raise ValueError(f"{layer}: {num_heads} heads are not divisible by "
                             f"trainer.mesh.tensor={self.size}")
        return num_heads // self.size

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.group)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(y, self.group)


def split_layers(shapes: dict, size: int) -> dict[str, str]:
    """Layer name -> 'col' | 'row' for the layers of a component's
    ``shapes`` (name -> shape) that the tensor axis splits: the weights
    ``tp_dim`` shards, and the feed-forwards whose hidden divides."""
    layers: dict[str, str] = {}
    for k, shape in shapes.items():
        dim = tp_dim(k, tuple(shape), size)
        if dim is not None:
            layers[k[:-len(".weight")]] = "col" if dim == 0 else "row"
    for layer, kind in list(layers.items()):
        if kind == "col" and _is_geglu(layer, shapes) and (shapes[f"{layer}.weight"][0] // 2) % size:
            # a GEGLU half the ranks cannot split evenly: the feed-forward stays whole
            layers.pop(layer)
            layers.pop(_ff_out(layer), None)
    return layers


def _ff_out(layer: str) -> Optional[str]:
    for proj, out in ((".ff.net.0.proj", ".ff.net.2"),
                      (".ff_context.net.0.proj", ".ff_context.net.2")):
        if layer.endswith(proj):
            return layer[:-len(proj)] + out
    return None


def _is_geglu(layer: str, shapes: dict) -> bool:
    """A feed-forward input projection whose rows are [value; gate]: twice
    the hidden its output projection reads."""
    out = _ff_out(layer)
    if out is None or f"{out}.weight" not in shapes:
        return False
    return tuple(shapes[f"{layer}.weight"])[0] == 2 * tuple(shapes[f"{out}.weight"])[1]


def _rows(t: torch.Tensor, index: int, size: int, geglu: bool) -> torch.Tensor:
    if not geglu:
        n = t.shape[0] // size
        return t[index * n:(index + 1) * n]
    value, gate = t.chunk(2, dim=0)
    n = value.shape[0] // size
    return torch.cat([value[index * n:(index + 1) * n], gate[index * n:(index + 1) * n]])


def _cols(t: torch.Tensor, index: int, size: int) -> torch.Tensor:
    n = t.shape[1] // size
    return t[:, index * n:(index + 1) * n]


def tp_view(params: dict, tp: TensorParallel) -> dict:
    """The rank's view of a component's params: the split layers' weights
    (and column biases, and the LoRA factor read under the shard) sliced,
    everything else as it is, and ``TENSOR_PARALLEL`` set."""
    out = dict(params)
    shapes = {k: tuple(v.shape) for k, v in params.items() if isinstance(v, torch.Tensor)}
    for layer, kind in tp.layers.items():
        if kind == "col":
            geglu = _is_geglu(layer, shapes)
            for name in (f"{layer}.weight", f"{layer}.bias", f"{layer}.lora_B"):
                if name in out:
                    out[name] = _rows(out[name], tp.index, tp.size, geglu)
        else:
            for name in (f"{layer}.weight", f"{layer}.lora_A"):
                if name in out:
                    out[name] = _cols(out[name], tp.index, tp.size)
    out[TENSOR_PARALLEL] = tp
    return out


def tensor_sum_keys(layers: dict, keys, prefix: str) -> set[str]:
    """The prefixed trainable ``keys`` whose gradients are partial on each
    tensor rank: the split layers' weights, column biases and LoRA factors
    (a row-parallel bias is added after the sum: its gradient is whole)."""
    out = set()
    for layer, kind in layers.items():
        names = ["weight", "lora_A", "lora_B"] + (["bias"] if kind == "col" else [])
        for n in names:
            k = f"{prefix}.{layer}.{n}"
            if k in keys:
                out.add(k)
    return out
