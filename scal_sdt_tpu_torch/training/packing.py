"""The host half of the JAX package's parameter packing (port of
``scal_sdt_tpu/training/packing.py``: ``build_pack_spec``, ``PackSpec``,
``LeafSlot``, ``unpack_host``, ``repack_host``, ``packed_labels``).

The JAX trainer keeps every fp32 trainable leaf under ``min_slab_size``
elements of one (component, optimizer group) in a 1-D slab, zero padded to a
multiple of 1024, and (``trainer.pack_stacks``) the big leaves of one shape
in an (N, *shape) stack. The port keeps its parameters natural, so it needs
the spec for two things only:

* Adafactor, whose numbers depend on the blocks it sees: a slab is one
  unfactored block with one RMS clip, padding counted in the mean
  (``training/optimizers.py``);
* reading a JAX run's optimizer state, whose moments sit in those slabs and
  stacks on disk (``convert/from_jax.py``).

The host functions take torch tensors (numpy arrays are converted), so bf16
state unpacks without a numpy bfloat16 type.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

SLAB_MARK = ".__slab__."
STACK_MARK = ".__stack__."
SLAB_PAD_MULTIPLE = 1024
DEFAULT_MIN_SLAB_SIZE = 1 << 18


class LeafSlot(NamedTuple):
    key: str
    shape: tuple[int, ...]
    offset: int
    size: int


class PackSpec(NamedTuple):
    """slabs: (slab key, padded length, leaf slots) per small-leaf group;
    stacks: (stack key, member keys in stack order, member shape);
    passthrough: the keys kept natural."""
    slabs: tuple[tuple[str, int, tuple[LeafSlot, ...]], ...]
    stacks: tuple[tuple[str, tuple[str, ...], tuple[int, ...]], ...]
    passthrough: tuple[str, ...]

    @property
    def packed_keys(self) -> set[str]:
        out = {s.key for _, _, slots in self.slabs for s in slots}
        out.update(k for _, members, _ in self.stacks for k in members)
        return out

    @property
    def slab_keys(self) -> tuple[str, ...]:
        return tuple(k for k, _, _ in self.slabs)

    @property
    def stack_keys(self) -> tuple[str, ...]:
        return tuple(k for k, _, _ in self.stacks)

    @property
    def container_keys(self) -> set[str]:
        return set(self.slab_keys) | set(self.stack_keys)

    @property
    def nontrivial(self) -> bool:
        return bool(self.slabs or self.stacks)


def _component_of(key: str) -> str:
    return key.split(".", 1)[0]


def _is_float32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


def build_pack_spec(shapes: dict[str, Any], labels: Optional[dict[str, str]] = None,
                    min_slab_size: int = DEFAULT_MIN_SLAB_SIZE, stack_big: bool = True,
                    exclude: Optional[set] = None) -> PackSpec:
    """Small fp32 leaves into per-(component, group) slabs, big same-shape
    leaves into stacks; ``shapes``: key -> anything with ``.shape`` and
    ``.dtype`` (torch or numpy), as the JAX trainer sees them before a bf16
    master cast."""
    def label_of(key: str) -> str:
        return labels.get(key, "default") if labels is not None else "default"

    slab_groups: dict[str, list[tuple[str, tuple[int, ...], int]]] = {}
    fam_groups: dict[tuple[str, str, tuple[int, ...]], list[str]] = {}
    passthrough: list[str] = []
    for key in sorted(shapes):
        v = shapes[key]
        shape = tuple(v.shape)
        size = int(np.prod(shape)) if shape else 1
        if not _is_float32(v.dtype) or (exclude and key in exclude):
            passthrough.append(key)
        elif size < min_slab_size:
            slab_key = f"{_component_of(key)}{SLAB_MARK}{label_of(key)}"
            slab_groups.setdefault(slab_key, []).append((key, shape, size))
        elif stack_big and len(shape) >= 1:
            fam_groups.setdefault((_component_of(key), label_of(key), shape), []).append(key)
        else:
            passthrough.append(key)

    slabs = []
    for slab_key in sorted(slab_groups):
        leaves = slab_groups[slab_key]
        if len(leaves) == 1:
            passthrough.append(leaves[0][0])
            continue
        slots, off = [], 0
        for key, shape, size in leaves:
            slots.append(LeafSlot(key, shape, off, size))
            off += size
        padded = -(-off // SLAB_PAD_MULTIPLE) * SLAB_PAD_MULTIPLE
        slabs.append((slab_key, padded, tuple(slots)))

    stacks = []
    counters: dict[tuple[str, str], int] = {}
    for (comp, label, shape) in sorted(fam_groups, key=str):
        members = fam_groups[(comp, label, shape)]
        if len(members) == 1:
            passthrough.append(members[0])
            continue
        i = counters.get((comp, label), 0)
        counters[(comp, label)] = i + 1
        stacks.append((f"{comp}{STACK_MARK}{label}.{i}", tuple(members), shape))
    return PackSpec(tuple(slabs), tuple(stacks), tuple(sorted(passthrough)))


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def unpack_host(packed: dict, spec: Optional[PackSpec]) -> dict:
    """Packed dict -> natural per-leaf dict (views of the containers)."""
    if spec is None or not spec.nontrivial:
        return dict(packed)
    containers = spec.container_keys
    out = {k: v for k, v in packed.items() if k not in containers}
    for slab_key, _, slots in spec.slabs:
        if slab_key in packed:
            slab = _tensor(packed[slab_key])
            for s in slots:
                out[s.key] = slab[s.offset:s.offset + s.size].reshape(s.shape)
    for stack_key, members, _ in spec.stacks:
        if stack_key in packed:
            arr = _tensor(packed[stack_key])
            for i, k in enumerate(members):
                out[k] = arr[i]
    return out


def repack_host(natural: dict, spec: Optional[PackSpec],
                template: Optional[dict] = None) -> dict:
    """Natural per-leaf dict -> packed dict (fp32 containers). Packs none of
    whose members are in ``natural`` are left out; a partly covered pack
    takes its other members from ``template[pack key]`` when given, else
    zeros."""
    if spec is None or not spec.nontrivial:
        return dict(natural)
    packed_keys = spec.packed_keys
    out = {k: v for k, v in natural.items() if k not in packed_keys}
    for slab_key, padded, slots in spec.slabs:
        present = [s for s in slots if s.key in natural]
        if not present:
            continue
        if len(present) < len(slots) and template is not None and slab_key in template:
            slab = _tensor(template[slab_key]).float().clone()
        else:
            slab = torch.zeros(padded, dtype=torch.float32)
        for s in present:
            slab[s.offset:s.offset + s.size] = _tensor(natural[s.key]).float().reshape(-1)
        out[slab_key] = slab
    for stack_key, members, shape in spec.stacks:
        present = [k for k in members if k in natural]
        if not present:
            continue
        if len(present) < len(members) and template is not None and stack_key in template:
            arr = _tensor(template[stack_key]).float().clone()
        else:
            arr = torch.zeros((len(members),) + tuple(shape), dtype=torch.float32)
        for i, k in enumerate(members):
            if k in natural:
                arr[i] = _tensor(natural[k]).float()
        out[stack_key] = arr
    return out


def packed_labels(spec: PackSpec) -> dict[str, str]:
    """The optimizer group label of each slab and stack key."""
    out = {k: k.split(SLAB_MARK, 1)[1] for k in spec.slab_keys}
    out.update({k: k.split(STACK_MARK, 1)[1].rsplit(".", 1)[0] for k in spec.stack_keys})
    return out
