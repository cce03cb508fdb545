"""Resuming a JAX run's optimizer state in the port, and the port's own
sidecar, for every optimizer family, on the CPU.

* The msgpack reader (``utils/msgpack.py``) against
  ``flax.serialization.to_bytes`` on trees with bf16, int8, 0-dim and nested
  optax states, and on chunked leaves: bit for bit. The port's copy of the
  packing's host half (``training/packing.py``) against JAX's: the same
  spec, labels, unpacked leaves and repacked containers, exactly.
* For every family, with the JAX trainer's slab packing and without: the
  JAX package runs 2 steps and writes its checkpoint (``save_checkpoint``:
  the ``.safetensors`` and the msgpack ``.trainstate``); the port restores it
  (``restore_train_state`` with the pack spec the config implies). The
  restored state equals the JAX state mapped from the live arrays
  (``opt_state_from_jax``) bit for bit, and the port's next step matches
  JAX's next step within the family's tolerance of
  tests/test_torch_optimizers.py (bit for bit for SGD, Lion and Adam with
  explicit moment dtypes; Adafactor 1e-6 and Prodigy / D-Adapt 1e-4 of each
  tensor's largest entry, ``estim_lr`` 1e-5 relative).
* A packed JAX AdamW8bit run (``param_packing: true``, stacks and not,
  with accumulation, ``SSDT_INT8_FUSED_MIN`` lowered so the tiny UNet's
  conv leaves and stacks are int8; the full_unet target's groups): the
  restored int8 payloads, scales and fp32 moments (slab members included)
  equal JAX's read per leaf bit for bit, and the next step matches JAX's
  within difference (c). Every SD1.5 stack family's int8 view splits into
  whole member rows; a stack whose blocks would straddle its members gives
  each its share of the stack's view.
* The port's own sidecar: a resume is bit-equal for every family.
* The whole slice: ``cli.train --resume`` of a JAX Trainer's Prodigy LoRA
  checkpoint (the shipped ``lora`` target, JAX's default packing, its 8-device
  CPU mesh) goes on with JAX's draws and ends within the whole-slice bounds of
  JAX's next checkpoint (difference (j)); ``estim_lr`` within 1e-5 relative.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.training import checkpoint as jckpt
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import packing as jpacking
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.training.trainer import Trainer as JTrainer

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import train as tcli
from scal_sdt_tpu_torch.convert.from_jax import (_ADAM8_FIELDS, _find_state, _get,
                                                 opt_state_from_jax)
from scal_sdt_tpu_torch.training import checkpoint as tckpt
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import packing as tpacking
from scal_sdt_tpu_torch.training.quantized import _stores_int8
from scal_sdt_tpu_torch.training.step import init_train_state
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import msgpack as tmsgpack

from helpers import make_image_dataset
from test_torch_data import write_vocab
from test_torch_optimizers import (LABELS, OVERRIDES, PACK_MIN, SHAPES, assert_close, assert_exact,
                                   bf16_grads, config, jax_apply, masters)
from test_torch_trainer import _check_masters, _port_draws
from torch_port_helpers import tiny_model_dir, to_np, to_torch


# --- the msgpack reader ------------------------------------------------------------

def _flat(node, prefix=""):
    """{path: leaf} of a nested state dict."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: node}


def _trees():
    r = np.random.RandomState(0)
    p = {"a": jnp.asarray(r.randn(3, 5), jnp.bfloat16), "b": jnp.asarray(r.randn(130, 129))}
    chain = optax.chain(optax.scale_by_factored_rms(), optax.clip_by_block_rms(1.0),
                        optax.add_decayed_weights(0.1), optax.scale_by_schedule(lambda s: -1.0))
    multi = optax.multi_transform({"g": optax.scale_by_lion(mu_dtype=jnp.bfloat16),
                                   "h": optax.contrib.prodigy()},
                                  lambda t: {"a": "g", "b": "h"})
    return {
        "arrays": {"bf16": p["a"], "int8": np.arange(-7, 8, dtype=np.int8).reshape(3, 5),
                   "zero_dim": jnp.asarray(2.5, jnp.float32), "i32": jnp.asarray(7, jnp.int32),
                   "u32_key": jax.random.PRNGKey(3), "np_scalar": np.float32(1.25),
                   "numbers": {"int": 3, "neg": -40000, "big": 2 ** 40, "float": 1.5,
                               "none": None, "true": True, "text": "slab"},
                   "empty": np.zeros((0, 4), np.float32)},
        "factored": chain.init(p),
        "multi_transform": multi.init(p),
    }


@pytest.mark.parametrize("tree", ["arrays", "factored", "multi_transform"])
def test_msgpack_reads_what_flax_writes(tree):
    target = _trees()[tree]
    data = serialization.to_bytes(target)
    got = _flat(tmsgpack.read_flax_state(data))
    want = _flat(serialization.msgpack_restore(data))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)):
            assert isinstance(g, torch.Tensor), k
            assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name, k
            assert tuple(g.shape) == np.shape(w), k
            assert np.array_equal(to_np(g), np.asarray(w).astype(to_np(g).dtype)), k
        else:
            assert g == w and type(g) is type(w), k


def test_msgpack_joins_chunked_leaves(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "nested": {"bf16": np.asarray(jnp.arange(60, dtype=jnp.bfloat16).reshape(3, 20))}}
    got = tmsgpack.read_flax_state(serialization.to_bytes(tree))
    assert torch.equal(got["big"], torch.arange(100, dtype=torch.float32).reshape(4, 25))
    assert got["nested"]["bf16"].dtype == torch.bfloat16
    assert torch.equal(got["nested"]["bf16"].float(), torch.arange(60.0).reshape(3, 20))


def test_msgpack_refuses_what_it_cannot_read():
    with pytest.raises(ValueError, match="truncated"):
        tmsgpack.unpackb(serialization.to_bytes({"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="after the object"):
        tmsgpack.unpackb(b"\x01\x02")


# --- the host half of the packing -------------------------------------------------------

@pytest.mark.parametrize("stacks", [False, True])
def test_pack_spec_and_host_packing_match_jax(stacks):
    """The port's ``build_pack_spec``, ``unpack_host``, ``repack_host`` (a
    partly covered pack filled from a template) and ``packed_labels``
    against the JAX package's, fp32 and bf16 leaves, with and without
    stacks."""
    r = np.random.RandomState(1)
    shapes = {**SHAPES, "unet.f.weight": (160, 136), "unet.g.weight": (8, 4, 3, 3),
              "condition_model.encoder.h.weight": (48, 40), "unet.i.bf16": (7,)}
    labels = {**LABELS, "unet.f.weight": "g0", "unet.g.weight": "g0",
              "condition_model.encoder.h.weight": "g0", "unet.i.bf16": "g1"}
    natural = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    natural["unet.i.bf16"] = np.asarray(jnp.asarray(natural["unet.i.bf16"], jnp.bfloat16))
    jspec = jpacking.build_pack_spec(natural, labels, min_slab_size=PACK_MIN, stack_big=stacks)
    tspec = tpacking.build_pack_spec({k: to_torch(v) for k, v in natural.items()}, labels,
                                     min_slab_size=PACK_MIN, stack_big=stacks)
    assert tspec == jspec and bool(tspec.stacks) == stacks
    assert tpacking.packed_labels(tspec) == jpacking.packed_labels(jspec)
    jpacked = jpacking.pack(natural, jspec, np_out=True)
    tnat = tpacking.unpack_host({k: to_torch(v) for k, v in jpacked.items()}, tspec)
    assert tnat.keys() == natural.keys()
    for k, v in natural.items():
        assert np.array_equal(to_np(tnat[k]), to_np(v)), k
    # a repack from part of the leaves, the rest from a template
    part = {k: v for k, v in natural.items() if k != "unet.a.bias"}
    template = {k: np.full_like(v, 7.0) for k, v in jpacked.items() if k in jspec.container_keys}
    want = jpacking.repack_host(part, jspec, template)
    got = tpacking.repack_host({k: to_torch(v) for k, v in part.items()}, tspec,
                               {k: torch.from_numpy(v) for k, v in template.items()})
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(to_np(got[k]), to_np(v)), k


# --- a JAX .trainstate resumed by the port, every family -----------------------------------

FAMILIES = {  # config name, config extras: explicit moment dtypes where JAX allows it
    "adamw": ("adamw", {"moment": "mixed"}),
    "adam": ("adam", {"moment": "mixed"}),
    "adamw8bit": ("adamw8bit", {}),
    "lion": ("lion", {}),
    "adafactor": ("adafactor", {}),
    "prodigy": ("prodigy", {}),
    "dadapt": ("dadaptation.DAdaptAdam", {}),
    "sgd": ("sgd", {}),
    "lion_accumulate": ("lion", {"accumulate": 2}),
}
EXACT = ("adamw", "adam", "lion", "sgd", "lion_accumulate")


def _packed(d: dict, spec) -> dict:
    """JAX's pack of a natural dict, in its own dtype (the gradient slabs of
    the JAX step keep the cotangents' dtype)."""
    if spec is None:
        return d
    out = {k: v for k, v in d.items() if k not in spec.packed_keys}
    for slab_key, padded, slots in spec.slabs:
        parts = [jnp.ravel(d[s.key]) for s in slots]
        parts.append(jnp.zeros((padded - sum(s.size for s in slots),), parts[0].dtype))
        out[slab_key] = jnp.concatenate(parts)
    return out


def _jax_run(family, packing, tmp_path, steps=2):
    """JAX's chain for ``steps`` steps on the (packed) dict, its checkpoint
    written by the JAX package; returns what the next step needs."""
    name, extra = FAMILIES[family]
    values, jp, _ = masters("fp32")
    kw = dict(moment=extra.get("moment"), packing=packing, accumulate=extra.get("accumulate", 1))
    jcfg, tcfg = config(jconf, name, **kw), config(tconf, name, **kw)
    jspec = (jpacking.build_pack_spec(values, LABELS, min_slab_size=PACK_MIN, stack_big=False)
             if packing else None)
    jlabels = dict(LABELS)
    if jspec is not None:
        jlabels = {**{k: v for k, v in LABELS.items() if k not in jspec.packed_keys},
                   **jpacking.packed_labels(jspec)}
    jtx, _ = jopt.build_optimizer(jcfg, jlabels, OVERRIDES, 100, 1)
    jstate = jtx.init(_packed(jp, jspec))
    for i in range(steps):
        jg, _ = bf16_grads(i)
        ju, jstate = jtx.update(_packed(jg, jspec), jstate, _packed(jp, jspec))
        ju = (ju if jspec is None else {k: jnp.asarray(v) for k, v in jpacking.unpack_host(
            {k: np.asarray(v) for k, v in ju.items()}, jspec).items()})
        jp = jax_apply(jp, ju, i)
    path = tmp_path / "jax.safetensors"
    train = jstep.TrainState(step=jnp.asarray(steps, jnp.int32), trainable=_packed(jp, jspec),
                             opt_state=jstate, ema=None, rng=jax.random.PRNGKey(0))
    jckpt.save_checkpoint(path, train, {}, pack_spec=jspec)
    return path, jtx, jstate, jp, jspec, tcfg


# a packed AdamW8bit state with int8 leaves and stacks: tested below
@pytest.mark.parametrize("family,packing", [(f, p) for f in FAMILIES for p in (True, False)])
def test_port_resumes_a_jax_trainstate(family, packing, tmp_path):
    path, jtx, jstate, jp, jspec, tcfg = _jax_run(family, packing, tmp_path)
    assert (tmp_path / "jax.safetensors.trainstate").exists()
    tspec = (tpacking.build_pack_spec({k: torch.zeros(s) for k, s in SHAPES.items()}, LABELS,
                                      PACK_MIN, False) if packing else None)
    assert tspec == jspec
    ttx, _ = topt.build_optimizer(tcfg, dict(LABELS), OVERRIDES, 100, 1, pack_spec=tspec)
    _, _, fresh = masters("fp32", seed=9)   # the template's values are overwritten
    template = init_train_state(fresh, ttx)
    tables_before = {k: v for k, v in template.trainable.items()}
    state = tckpt.restore_train_state(path, template, pack_spec=tspec)
    assert state.step == 2
    assert all(state.trainable[k] is tables_before[k] for k in SHAPES)   # restored in place

    # the restored state is JAX's, bit for bit
    want = opt_state_from_jax(jstate, device="cpu", pack_spec=jspec)
    got_t, got_n, want_t, want_n = {}, {}, {}, {}
    tckpt._flatten(state.opt_state, "s", got_t, got_n)
    tckpt._flatten(want, "s", want_t, want_n)
    assert got_n == want_n and got_t.keys() == want_t.keys()
    for k, v in want_t.items():
        assert got_t[k].dtype == v.dtype and torch.equal(got_t[k], v), k
    for k in SHAPES:
        assert torch.equal(state.trainable[k], to_torch(jp[k])), k

    # the next step in both packages
    jg, tg = bf16_grads(2)
    ju, jstate = jtx.update(_packed(jg, jspec), jstate, _packed(jp, jspec))
    if jspec is not None:
        ju = {k: jnp.asarray(v) for k, v in jpacking.unpack_host(
            {k: np.asarray(v) for k, v in ju.items()}, jspec).items()}
    jp = jax_apply(jp, ju, 2)
    opt = ttx.update_and_apply(tg, state.opt_state, state.trainable, 2)
    for k in SHAPES:
        if family in EXACT:
            assert_exact(state.trainable[k], jp[k], f"master {k}")
        elif family == "adafactor":
            assert_close(state.trainable[k], jp[k], 1e-6, f"master {k}")
        else:
            assert_close(state.trainable[k], jp[k], 1e-4, f"master {k}")
    want = opt_state_from_jax(jstate, device="cpu", pack_spec=jspec)
    got_t, want_t = {}, {}
    tckpt._flatten(opt, "s", got_t, {})
    tckpt._flatten(want, "s", want_t, {})
    for k, v in want_t.items():
        if family in EXACT:
            assert torch.equal(got_t[k], v), k
        elif k.endswith("estim_lr"):
            assert float(got_t[k]) == pytest.approx(float(v), rel=1e-5), k
        else:
            assert_close(got_t[k], v, 1e-4, k)


# --- a packed JAX AdamW8bit run resumed by the port ------------------------------------

INT8_MIN = 2048   # SSDT_INT8_FUSED_MIN of these cases: the tiny UNet's conv leaves are int8
# pack_stacks, pack_min_size, accumulate_grad_batches, steps before the checkpoint
PACKED8 = {"slabs": (False, 16384, 1, 2), "stacks": (True, 8192, 1, 2),
           "stacks_accumulate": (True, 8192, 2, 3)}


def _tiny_unet_labels():
    """The tiny UNet's leaves (prefixed) and the full_unet target's 7 group
    labels, and their overrides, as both packages resolve them."""
    from scal_sdt_tpu.training import optim_targets as jtargets
    from scal_sdt_tpu_torch.models.unet import UNetConfig, unet_param_shapes
    from scal_sdt_tpu_torch.training import optim_targets as ttargets

    shapes = unet_param_shapes(UNetConfig.tiny())
    tres = ttargets.resolve_optim_target(tconf.load_optim_target("full_unet"), shapes, [])
    jres = jtargets.resolve_optim_target(jconf.load_optim_target("full_unet"), shapes, [])
    labels = ttargets.group_labels(tres)
    assert labels == jtargets.group_labels(jres) and len(set(labels.values())) == 7
    overrides = {f"g{i}": dict(g.optimizer) for i, g in enumerate(tres["unet"].groups)}
    return {f"unet.{k}": tuple(v) for k, v in shapes.items()}, labels, overrides


def _pack8(d: dict, spec) -> dict:
    """JAX's pack of a natural dict in its own dtype: slabs zero padded,
    stacks along a new first axis."""
    out = _packed(d, spec)
    for stack_key, members, _ in spec.stacks:
        out.pop(stack_key, None)
        for k in members:
            out.pop(k, None)
        out[stack_key] = jnp.stack([d[k] for k in members])
    return out


def _adam8_groups(state) -> dict:
    """{label: (count, mu_q, mu_s, nu_q, nu_s)} of a live JAX AdamW8bit state
    (or the accumulation wrapper's around it)."""
    inner = state.inner_states if hasattr(state, "inner_states") else state[1].inner_states
    out = {}
    for label, s in inner.items():
        found = _find_state(s, _ADAM8_FIELDS)
        out[label] = (int(np.asarray(_get(found, "count"))),) + tuple(
            {k: np.asarray(v) for k, v in _get(found, f).items() if hasattr(v, "shape")}
            for f in _ADAM8_FIELDS[1:])
    return out


def _jax_unpacked8(payloads: dict, scales: dict, spec) -> tuple[dict, dict]:
    """JAX's packed moments read per leaf with numpy alone: slab slices, an
    fp32 stack's members, an int8 stack's rows split evenly (the test's own
    reading, independent of ``convert.from_jax``)."""
    q, sc = {}, {}
    for k, v in payloads.items():
        if k in scales:
            q[k], sc[k] = v, scales[k]
        else:
            q[k] = v
    for slab_key, _, slots in spec.slabs:
        if slab_key in q:
            slab = q.pop(slab_key)
            assert slab_key not in sc and slab.dtype == np.float32 and slab.ndim == 1
            for slot in slots:
                q[slot.key] = slab[slot.offset:slot.offset + slot.size].reshape(slot.shape)
    for stack_key, members, _ in spec.stacks:
        if stack_key not in q:
            continue
        arr = q.pop(stack_key)
        if stack_key in sc:
            scale = sc.pop(stack_key)
            n = len(members)
            for i, k in enumerate(members):
                q[k] = arr.reshape(n, arr.shape[0] // n, -1)[i]
                sc[k] = scale.reshape(n, scale.shape[0] // n, -1)[i]
        else:
            for i, k in enumerate(members):
                q[k] = arr[i]
    return q, sc


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.abs(x.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 0.0)


@pytest.mark.parametrize("case", list(PACKED8))
def test_port_resumes_a_packed_jax_adamw8bit_run(case, tmp_path, monkeypatch):
    """The JAX package runs AdamW8bit under ``param_packing: true`` on the
    tiny UNet's leaves (fp32 masters, the full_unet target's 7 groups), with
    stacks and without, and writes its checkpoint; the port restores it.
    The restored int8 payloads, scales and fp32 moments (slabs' members
    included, padding dropped) equal JAX's read per leaf bit for bit, and
    the accumulation wrapper's count and sums come across too. The port's
    next step then matches JAX's: updates as ``Adam8bit`` does (payloads at
    most 1 apart in under 1e-3, scales and fp32 moments within 1e-6
    relative, fp32 moments within 1e-6 of the tensor's largest entry by
    difference (d)), masters within difference (c): one fp32 ulp of the new
    master plus one bf16 ulp of the update."""
    stacks, pack_min, accumulate, steps = PACKED8[case]
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", str(INT8_MIN))
    shapes, labels, overrides = _tiny_unet_labels()
    r = np.random.RandomState(5)
    values = {k: (r.randn(*s) * 0.3).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    jspec = jpacking.build_pack_spec(values, labels, min_slab_size=pack_min, stack_big=stacks)
    tspec = tpacking.build_pack_spec({k: torch.zeros(s) for k, s in shapes.items()}, labels,
                                     pack_min, stacks)
    assert tspec == jspec and jspec.slabs and bool(jspec.stacks) == stacks
    jlabels = {**{k: v for k, v in labels.items() if k not in jspec.packed_keys},
               **jpacking.packed_labels(jspec)}
    kw = dict(packing=True, accumulate=accumulate)
    jcfg, tcfg = config(jconf, "adamw8bit", **kw), config(tconf, "adamw8bit", **kw)
    jtx, _ = jopt.build_optimizer(jcfg, jlabels, overrides, 100, 1)
    jstate = jtx.init(_pack8(jp, jspec))

    def grads(i):
        g = np.random.RandomState(200 + i)
        jg = {k: jnp.asarray((g.randn(*s) * 10.0 ** g.uniform(-3, 0, s)).astype(np.float32),
                             jnp.bfloat16) for k, s in sorted(shapes.items())}
        return jg, {k: to_torch(v) for k, v in jg.items()}

    def jax_step(jp, jstate, i):
        ju, jstate = jtx.update(_pack8(grads(i)[0], jspec), jstate, _pack8(jp, jspec))
        ju = {k: jnp.asarray(v) for k, v in jpacking.unpack_host(
            {k: np.asarray(v) for k, v in ju.items()}, jspec).items()}
        return jax_apply(jp, ju, i), jstate, ju

    for i in range(steps):
        jp, jstate, _ = jax_step(jp, jstate, i)
    path = tmp_path / "jax.safetensors"
    train = jstep.TrainState(step=jnp.asarray(steps, jnp.int32), trainable=_pack8(jp, jspec),
                             opt_state=jstate, ema=None, rng=jax.random.PRNGKey(0))
    jckpt.save_checkpoint(path, train, {}, pack_spec=jspec)

    ttx, _ = topt.build_optimizer(tcfg, dict(labels), overrides, 100, 1, pack_spec=tspec)
    fresh = {k: torch.zeros(s) for k, s in shapes.items()}   # overwritten by the restore
    state = tckpt.restore_train_state(path, init_train_state(fresh, ttx), pack_spec=tspec)
    assert state.step == steps
    for k in shapes:
        assert torch.equal(state.trainable[k], to_torch(jp[k])), k

    # the restored moments are JAX's, read per leaf, bit for bit
    groups = state.opt_state.inner if accumulate > 1 else state.opt_state
    kinds = {"int8 stack": 0, "int8 leaf": 0, "slab fp32 (int8 alone)": 0}
    in_slab = {slot.key for _, _, slots in jspec.slabs for slot in slots}
    stacked = {k for _, members, _ in jspec.stacks for k in members}
    for label, (count, mq, ms, nq, ns) in _adam8_groups(jstate).items():
        got = groups[label]
        assert got.count == count == steps // accumulate
        for pq, ps, tq_, ts in ((mq, ms, got.mu_q, got.mu_s), (nq, ns, got.nu_q, got.nu_s)):
            wq, ws = _jax_unpacked8(pq, ps, jspec)
            assert set(tq_) == set(wq) and set(ts) == set(ws), label
            for k in wq:
                assert str(tq_[k].dtype)[6:] == wq[k].dtype.name, k
                assert np.array_equal(to_np(tq_[k]), wq[k]), k
            for k in ws:
                assert np.array_equal(to_np(ts[k]), ws[k]), k
        for k in got.mu_q:
            if k in got.mu_s:
                kinds["int8 stack" if k in stacked else "int8 leaf"] += 1
            elif k in in_slab and _stores_int8(shapes[k], INT8_MIN):
                kinds["slab fp32 (int8 alone)"] += 1
    assert kinds["int8 leaf"] and (kinds["int8 stack"] if stacks
                                   else kinds["slab fp32 (int8 alone)"]), kinds
    if accumulate > 1:
        assert state.opt_state.mini == steps % accumulate
        for k, v in jpacking.unpack_host({k: np.asarray(v) for k, v in jstate[2].items()},
                                         jspec).items():
            assert np.array_equal(to_np(state.opt_state.acc[k]), to_np(v)), k
        assert any(to_np(v).any() for v in state.opt_state.acc.values())

    # the next step in both packages
    jp, jstate, ju = jax_step(jp, jstate, steps)
    opt = ttx.update_and_apply(grads(steps)[1], state.opt_state, state.trainable, steps)
    for k in shapes:
        want = to_np(jp[k]).astype(np.float64)
        tol = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64) + _bf16_ulp(
            to_np(ju[k]))
        bad = np.abs(to_np(state.trainable[k]).astype(np.float64) - want) > tol
        assert not bad.any(), f"master {k}: {bad.sum()} beyond (c)"
    assert any(not np.array_equal(to_np(state.trainable[k]), values[k]) for k in shapes)
    groups = opt.inner if accumulate > 1 else opt
    for label, (count, mq, ms, nq, ns) in _adam8_groups(jstate).items():
        got = groups[label]
        assert got.count == count
        for pq, ps, tq_, ts in ((mq, ms, got.mu_q, got.mu_s), (nq, ns, got.nu_q, got.nu_s)):
            wq, ws = _jax_unpacked8(pq, ps, jspec)
            for k in wq:
                g, w = to_np(tq_[k]), wq[k]
                if k in ws:
                    d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                    assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
                    np.testing.assert_allclose(to_np(ts[k]), ws[k], rtol=1e-6, err_msg=k)
                else:   # difference (d): XLA may contract b*m + (1-b)*g into an fma
                    assert_close(g, w, 1e-6, f"{label} {k}")


@pytest.mark.parametrize("stacks", [False, True])
def test_every_sd15_stack_family_splits_into_member_rows(stacks):
    """SD1.5 under the full_unet target (JAX's default ``pack_min_size``
    2^18 and ``SSDT_INT8_FUSED_MIN`` 2^18): the 459 leaves under 2^18 form
    one fp32 slab per group (7); without stacks no stack exists; with
    stacks, every one of the 39 stack families (per shape and group) is
    int8, and its int8 view
    (JAX's ``_leaf_view`` of the stack) is the member's with N times the
    lead, so each member owns whole rows in its own view; the port's
    ``int8_views`` names exactly the leaves whose moments JAX's packed run
    stores int8, each in its own view."""
    from scal_sdt_tpu.training import optim_targets as jtargets
    from scal_sdt_tpu.training import quantized as jq
    from scal_sdt_tpu_torch.models.unet import UNetConfig, unet_param_shapes
    from scal_sdt_tpu_torch.training import quantized as tq

    shapes = unet_param_shapes(UNetConfig.sd15())
    labels = jtargets.group_labels(jtargets.resolve_optim_target(
        jconf.load_optim_target("full_unet"), shapes, []))
    natural = {f"unet.{k}": jax.ShapeDtypeStruct(tuple(v), jnp.float32)
               for k, v in shapes.items()}
    spec = jpacking.build_pack_spec(natural, labels, stack_big=stacks)
    assert sum(len(slots) for _, _, slots in spec.slabs) == 459
    assert len(spec.slabs) == 7 and len(spec.stacks) == (39 if stacks else 0)
    want = {k for k in spec.passthrough if jq._stores_int8(natural[k].shape, 1 << 18)}
    for stack_key, members, shape in spec.stacks:
        n = len(members)
        assert jq._stores_int8((n,) + tuple(shape), 1 << 18), stack_key
        lead_s, minor_s, nb_s = jq._leaf_view((n,) + tuple(shape))
        lead, minor, nb = jq._leaf_view(tuple(shape))
        assert (lead_s, minor_s, nb_s) == (n * lead, minor, nb), stack_key
        assert tq.stack_member_view(stack_key, shape, n) == (lead, minor, nb)
        want.update(members)
    got = tq.int8_views({k: v.shape for k, v in natural.items()}, 1 << 18,
                        tpacking.PackSpec(*spec))
    assert set(got) == want and len(got) == 227
    assert all(v == tq._leaf_view(natural[k].shape) for k, v in got.items())


def test_a_stack_whose_blocks_straddle_members_keeps_the_stack_view(monkeypatch):
    """Where a stack's int8 view is not its members' own views stacked (a
    member (4, 300) alone is 4 rows of 2 blocks, the stack (2, 4, 300) 2 rows
    of 5 blocks), each member takes its share of the stack's view: the
    port's AdamW8bit then lays out and quantizes its moments in JAX's packed
    blocks, and the plain update runs on that view."""
    from scal_sdt_tpu_torch.training import quantized as tq

    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "512")
    assert tq.stack_member_view("s", (64, 64, 3, 3), 8) == (64, 576, 3)
    assert tq._leaf_view((4, 300)) == (4, 300, 2)
    assert tq.stack_member_view("s", (4, 300), 2) == (1, 1200, 5)
    spec = tpacking.PackSpec((), (("unet.__stack__.g0.0", ("unet.a", "unet.b"), (4, 300)),),
                             ("unet.c",))
    shapes = {"unet.a": (4, 300), "unet.b": (4, 300), "unet.c": (4, 300)}
    assert tq.int8_views(shapes, 512, spec) == {"unet.a": (1, 1200, 5), "unet.b": (1, 1200, 5),
                                                "unet.c": (4, 300, 2)}
    assert tq.int8_views(shapes, 512) == {k: (4, 300, 2) for k in shapes}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    state = tq.Adam8bit().init(params, spec)
    assert tuple(state.mu_q["unet.a"].shape) == (1, 1280)
    assert tuple(state.mu_s["unet.a"].shape) == (1, 5)
    assert tuple(state.mu_q["unet.c"].shape) == (4, 512)
    gen = torch.Generator().manual_seed(1)
    grads = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    updates, state = tq.Adam8bit().update(grads, state)
    assert all(torch.isfinite(u).all() and u.shape == grads[k].shape for k, u in updates.items())
    # a stack view whose rows the members cannot share is refused, naming the shape
    with pytest.raises(ValueError, match=r"\(3, 1, 100\).*cannot share"):
        tq.stack_member_view("unet.__stack__.g0.1", (1, 100), 3)


# --- the port's own sidecar, every family ------------------------------------------------

SIDECAR = {"adamw": "adamw", "adamw8bit": "adamw8bit", "adam": "adam", "lion": "lion",
           "adafactor": "adafactor", "prodigy": "prodigy", "dadapt": "dadaptation.DAdaptAdam",
           "sgd": "sgd", "lion_accumulate": "lion"}


@pytest.mark.parametrize("family", list(SIDECAR))
def test_port_sidecar_resume_is_bit_equal(family, tmp_path):
    """3 steps, a checkpoint, 2 more steps; against a fresh state restored
    from that checkpoint and the same 2 steps: masters and every state
    tensor and count bit for bit (bf16 masters and moments; Prodigy's and
    D-Adapt's 0-dim scalars included)."""
    kw = dict(moment="bf16" if family in ("adamw", "adam", "lion") else None, packing=True,
              accumulate=2 if family == "lion_accumulate" else 1)
    cfg = config(tconf, SIDECAR[family], "bf16", **kw)
    spec = tpacking.build_pack_spec({k: torch.zeros(s) for k, s in SHAPES.items()}, LABELS,
                                    PACK_MIN, False)
    tx, _ = topt.build_optimizer(cfg, dict(LABELS), OVERRIDES, 100, 1, pack_spec=spec)
    _, _, tp = masters("bf16")
    state = init_train_state(tp, tx)
    for i in range(3):
        state = state._replace(step=i + 1, opt_state=tx.update_and_apply(
            bf16_grads(i)[1], state.opt_state, state.trainable, i))
    path = tmp_path / "ckpt.safetensors"
    tckpt.save_checkpoint(path, state, {})
    _, _, other = masters("bf16", seed=4)
    resumed = tckpt.restore_train_state(path, init_train_state(other, tx), pack_spec=spec)
    assert resumed.step == state.step == 3
    for s in (state, resumed):
        opt = s.opt_state
        for i in range(3, 5):
            opt = tx.update_and_apply(bf16_grads(i)[1], opt, s.trainable, i)
        s.trainable["__opt__"] = opt
    a, b, na, nb = {}, {}, {}, {}
    tckpt._flatten(state.trainable.pop("__opt__"), "s", a, na)
    tckpt._flatten(resumed.trainable.pop("__opt__"), "s", b, nb)
    assert na == nb and a.keys() == b.keys() and (a or family == "sgd")
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for k in SHAPES:
        assert torch.equal(state.trainable[k], resumed.trainable[k]), k


# --- the whole slice: cli.train --resume of a JAX Prodigy LoRA run ----------------------------

BATCH, IMAGES, RES = 8, 16, 32


@pytest.fixture(scope="module")
def lora_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prodigy")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=IMAGES)
    user = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": BATCH,
            "seed": 3, "num_workers": 2, "optim_target": "lora",
            "data": {"resolution": RES, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
            "trainer": {"precision": "32", "max_steps": 3, "max_epochs": 2},
            "optimizer": {"name": "prodigyopt.Prodigy", "params": {"lr": 1.0},
                          "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_train_steps": 1,
                           "every_n_epochs": None}}
    return tmp, user


def test_cli_resumes_a_jax_prodigy_lora_run(lora_run, monkeypatch):
    tmp, user = lora_run
    jcfg = jconf.merge(jconf.default(), user, {"trainer": {"mesh": {"data": 8}}})
    jtr = JTrainer(jcfg, tmp / "jax")
    assert jtr.pack_spec is not None and jtr.pack_spec.slabs   # JAX's default packing
    rng0 = np.asarray(jtr.state.rng)
    jtr.fit(max_steps_override=3)
    jdir = tmp / "jax"
    assert (jdir / "epoch=0-step=2.safetensors.trainstate").exists()

    # the port resumes JAX's step-2 checkpoint from a run dir holding its config
    port = tmp / "out" / "SCAL-SDT" / "from_jax"
    port.mkdir(parents=True)
    for name in ("epoch=0-step=2.safetensors", "epoch=0-step=2.safetensors.trainstate"):
        shutil.copy(jdir / name, port / name)
    tconf.save(tconf.merge(tconf.default(), tconf.Config(json.loads(json.dumps(user)))),
               port / "config.yaml")
    real_fit = TTrainer.fit
    seen = {}

    def fit(self, *args, **kwargs):
        seen["trainer"] = self
        return real_fit(self, *args, draws_fn=_port_draws(rng0, jtr.spec, cached=False),
                        **kwargs)

    monkeypatch.setattr(TTrainer, "fit", fit)
    result = CliRunner().invoke(tcli.main, ["--resume", str(port / "epoch=0-step=2.safetensors"),
                                            "--run-id", "resumed", "--device", "cpu"])
    assert result.exit_code == 0, repr(result.exception)
    ttr = seen["trainer"]
    assert ttr.pack_spec == tpacking.PackSpec(*jtr.pack_spec)
    assert ttr.global_step == 3
    final = tmp / "out" / "SCAL-SDT" / "resumed" / "epoch=1-step=3.safetensors"
    assert final.exists()

    jnat = jtr.natural_trainable()
    tnat = ttr.natural_trainable()
    assert tnat.keys() == jnat.keys()
    _check_masters(tnat, jnat, bf16=False, lr=1e-6, steps=1)
    jstate = opt_state_from_jax(jtr.state.opt_state, device="cpu", pack_spec=jtr.pack_spec)
    for label, group in ttr.state.opt_state.items():
        assert group.count == jstate[label].count == 3
        assert float(group.estim_lr) == pytest.approx(float(jstate[label].estim_lr), rel=1e-5)
        for k, v in group.params0.items():   # the JAX run's initial masters, unpacked
            assert torch.equal(v, jstate[label].params0[k]), k
