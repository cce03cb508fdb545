"""Many param groups in one launch: the merged ``adam_bf16_fused`` and
``ema_fused`` entries over a LoRA-like tree, on the CPU.

The tree is 14 modules of two rank-4 factors each, every module its own
param group as the LoRA optim targets make them: 10 UNet modules at one lr
and decay, 4 text-encoder modules at another lr without decay, a warm-up
into a cosine schedule, bf16 gradients. ``MultiTransform.update_and_apply``
runs every group's leaves through one leaf table (on a card one launch),
each group with its own scalars (``GroupStep``); on the CPU the table's plain
version runs them leaf by leaf.

* Over 3 steps, AdamW with bf16 moments (fp32 and bf16 masters), the default
  AdamW (fp32 masters, no moment dtype: the ``xla`` rounding) and AdamW8bit
  (whose LoRA-sized leaves keep fp32 moments): masters and moments bit for
  bit against each group's own ``update`` then ``apply_updates``, with the
  counts of some groups moved ahead of the others' before the second step.
  One table holds all 14 groups; every element of every leaf lies in one
  chunk and each chunk names its leaf's group.
* The same tree against the JAX package's ``optax.multi_transform``
  (``build_optimizer``): bit for bit, masters and moments (JAX's plain
  ``scale_by_adam`` under ``jax.jit``, the others eager, as
  tests/test_torch_optimizers.py and tests/test_torch_quantized.py hold the
  one-group chains).
* The group records the launch stages: each group's bias corrections,
  count, rounded decay and step size.
* ``ema_update`` over every UNet key of the tree, one table, against JAX's
  ``ema_update``: bf16 shadows bit for bit, fp32 ones within one fp32 ulp
  (XLA contracts the update into an fma, as tests/test_torch_ema.py states).

The kernels run the same tables on a card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.training import ema as jema
from scal_sdt_tpu.training import optimizers as jopt

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.ops import adam_bf16_fused as AF
from scal_sdt_tpu_torch.ops.sr import dither_seed
from scal_sdt_tpu_torch.training import ema as tema
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training.step import apply_updates

from test_torch_ema import _assert_shadow, _jax_ema_step
from test_torch_optimizers import assert_exact, jax_apply, jax_leaves
from torch_port_helpers import to_np, to_torch

RANK = 4
UNET_WIDTHS = [(32, 32), (48, 48), (64, 64), (40, 320), (320, 40), (37, 37), (96, 24),
               (24, 96), (64, 64), (48, 48)]
TEXT_WIDTHS = [(32, 32), (33, 32), (32, 128), (128, 32)]
MODULES = ([f"unet.blocks.{i}.attn" for i in range(len(UNET_WIDTHS))]
           + [f"condition_model.encoder.layers.{i}.mlp" for i in range(len(TEXT_WIDTHS))])
SHAPES = {}
for _module, (_in, _out) in zip(MODULES, UNET_WIDTHS + TEXT_WIDTHS):
    SHAPES[f"{_module}.lora_A"] = (RANK, _in)
    SHAPES[f"{_module}.lora_B"] = (_out, RANK)
LABELS = {k: f"g{MODULES.index(k.rsplit('.', 1)[0]):02d}" for k in SHAPES}
OVERRIDES = {f"g{i:02d}": ({"lr": 5e-4, "weight_decay": 1e-2} if m.startswith("unet.")
                           else {"lr": 5e-3, "weight_decay": 0.0})
             for i, m in enumerate(MODULES)}
AHEAD = ("g01", "g07", "g12")    # groups whose count runs 3 ahead from the second step
# (optimizer name, master dtype, moment dtype)
FORMS = {"bf16_moments": ("adamw", "fp32", "bf16"),
         "bf16_moments_bf16_masters": ("adamw", "bf16", "bf16"),
         "xla": ("adamw", "fp32", None),
         "adamw8bit": ("bitsandbytes.optim.AdamW8bit", "fp32", None)}


def _config(pkg, form: str):
    name, master, moment = FORMS[form]
    opt = {"name": name, "master_dtype": master,
           "params": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "weight_decay": 1e-2,
                      "eps": 1e-8},
           "lr_scale": {"enabled": False},
           "lr_scheduler": {"name": "cosine", "params": {"T_max": 2, "eta_min": 1e-6},
                            "warmup": {"enabled": True, "init_lr": 1e-6, "steps": 1,
                                       "strategy": "linear"}}}
    if moment is not None:
        opt["moment_dtype"] = moment
    return pkg.merge(pkg.default(), pkg.Config({"batch_size": 2,
                                                "trainer": {"precision": "bf16"},
                                                "optimizer": opt}))


def _masters(form: str) -> dict:
    r = np.random.RandomState(3)
    dtype = torch.bfloat16 if FORMS[form][1] == "bf16" else torch.float32
    return {k: torch.from_numpy((r.randn(*s) * 0.1).astype(np.float32)).to(dtype)
            for k, s in SHAPES.items()}


def _grads(step: int) -> dict:
    r = np.random.RandomState(100 + step)
    return {k: torch.from_numpy((r.randn(*s) * 10.0 ** r.uniform(-4, -1, s))
                                .astype(np.float32)).bfloat16() for k, s in SHAPES.items()}


def _moments(state: dict) -> dict:
    """(label, field, key) -> each moment tensor of a port state."""
    out = {}
    for label, s in state.items():
        for field in ("mu", "nu", "mu_q", "nu_q"):
            out.update({(label, field, k): v for k, v in getattr(s, field, {}).items()})
    return out


def _move_ahead(state: dict) -> None:
    for label in AHEAD:
        state[label].count += 3


def _tx(form: str):
    return topt.build_optimizer(_config(tconf, form), LABELS, OVERRIDES, 4, 1)[0]


@pytest.mark.parametrize("form", list(FORMS))
def test_merged_launch_equals_per_group_update_then_apply(form):
    tx = _tx(form)
    assert {type(t) for t in tx.transforms.values()} == {
        topt.AdamW8bit if form == "adamw8bit" else topt.AdamW}
    assert all(t.xla == (form == "xla") for t in tx.transforms.values()
               if isinstance(t, topt.AdamW))
    plain, fused = _masters(form), _masters(form)
    s_plain, s_fused = tx.init(plain), tx.init(fused)
    for step in range(3):
        if step == 1:
            _move_ahead(s_plain)
            _move_ahead(s_fused)
        grads = _grads(step)
        updates = {}
        for label, group in tx.transforms.items():
            keys = [k for k in SHAPES if LABELS[k] == label]
            u, s_plain[label] = group.update({k: grads[k] for k in keys}, s_plain[label],
                                             {k: plain[k] for k in keys})
            updates.update(u)
        plain = apply_updates(plain, updates, step)
        before = dict(fused)
        s_fused = tx.update_and_apply(grads, s_fused, fused, step)
        assert all(fused[k] is before[k] for k in fused)   # in place
        for k in SHAPES:
            assert torch.equal(fused[k], plain[k]), f"master step {step} {k}"
        want, got = _moments(s_plain), _moments(s_fused)
        assert want.keys() == got.keys() and len(want) == 2 * len(SHAPES)
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
        assert {k: s.count for k, s in s_fused.items()} == {k: s.count for k, s in s_plain.items()}
    assert {s.count for label, s in s_fused.items() if label in AHEAD} == {6}
    assert {s.count for label, s in s_fused.items() if label not in AHEAD} == {3}

    # one table over the 14 groups, in label order, each chunk naming its group
    (merged,) = tx.merged_launches(s_fused, fused)
    table = merged.table
    labels = sorted(OVERRIDES)
    assert merged.labels == labels
    assert table.keys == tuple(tuple(sorted(k for k in SHAPES if LABELS[k] == label))
                               for label in labels)
    keys = [k for group in table.keys for k in group]
    leaf_groups = {int(leaf): int(g) for leaf, _, g, _ in table.chunks}
    assert [labels[leaf_groups[i]] for i in range(len(keys))] == [LABELS[k] for k in keys]
    assert all(p is fused[k] for p, k in zip(table.params, keys))
    for i, k in enumerate(keys):
        n = int(np.prod(SHAPES[k]))
        mine = table.chunks[table.chunks[:, 0] == i, 1]
        hits = np.zeros(n, np.int64)
        for c in mine:
            hits[c * AF.CHUNK:(c + 1) * AF.CHUNK] += 1
        assert (hits == 1).all() and int(table.records["n"][i]) == n, k


@pytest.mark.parametrize("form", list(FORMS))
def test_merged_launch_matches_jax_multi_transform(form):
    """14 groups at two lrs through the port's merged launch (its plain
    version) and through JAX's multi_transform: masters and moments bit for
    bit after each of 3 steps."""
    jtx, _ = jopt.build_optimizer(_config(jconf, form), LABELS, OVERRIDES, 4, 1)
    tx = _tx(form)
    tp = _masters(form)
    jdt = jnp.bfloat16 if FORMS[form][1] == "bf16" else jnp.float32
    # copies: the port updates its masters in place, which a view would share
    jp = {k: jnp.asarray(to_np(v).copy(), jdt) for k, v in tp.items()}
    jstate, tstate = jtx.init(jp), tx.init(tp)
    jupdate = jax.jit(jtx.update) if form == "xla" else jtx.update
    fields = ("mu_q", "nu_q") if form == "adamw8bit" else ("mu", "nu")
    for step in range(3):
        tg = _grads(step)
        jg = {k: jnp.asarray(to_np(v), jnp.bfloat16) for k, v in tg.items()}
        ju, jstate = jupdate(jg, jstate, jp)
        jp = jax_apply(jp, ju, step)
        tstate = tx.update_and_apply(tg, tstate, tp, step)
        for k in SHAPES:
            assert_exact(tp[k], jp[k], f"master step {step} {k}")
        for field in fields:
            jm = jax_leaves(jstate, field)
            tm = {k: v for s in tstate.values() for k, v in getattr(s, field).items()}
            assert jm.keys() == tm.keys() == SHAPES.keys()
            for k in SHAPES:
                assert str(tm[k].dtype) == "torch." + str(jm[k].dtype), (field, k)
                assert_exact(tm[k], jm[k], f"{field} step {step} {k}")


def test_group_records_hold_each_groups_scalars():
    """The records one launch stages: a group's bias corrections (AdamW
    divides by them, AdamW8bit's fp32-moment leaves multiply by their fp32
    reciprocals), its count's and the step's dither seeds, its decay
    rounded to the masters' dtype and its step size to the update's."""
    tx = _tx("bf16_moments")
    state = tx.init(_masters("bf16_moments"))
    _move_ahead(state)
    steps = [tx.transforms[label].group_step(state[label].count) for label in sorted(OVERRIDES)]
    assert len({st.step_size for st in steps}) == 4     # two lrs at two counts
    for recip_bc, p_dtype, u_dtype in ((False, torch.float32, torch.float32),
                                       (True, torch.bfloat16, torch.bfloat16)):
        rec = AF.group_records(steps, recip_bc=recip_bc, p_dtype=p_dtype, u_dtype=u_dtype,
                               step=7)
        assert rec.dtype == AF._GROUP and len(rec) == len(steps)
        for r, st in zip(rec, steps):
            c = [np.float32(b) for b in st.bc]
            if recip_bc:
                c = [np.float32(1) / b for b in c]
            assert (r["c1"], r["c2"]) == tuple(c)
            assert r["nu_mix"] == dither_seed(st.count, 0) and r["step_mix"] == dither_seed(7, 0)
            assert r["has_wd"] == (st.weight_decay > 0)
            assert r["wd_p"] == torch.tensor(st.weight_decay, dtype=p_dtype).item()
            assert r["step_u"] == torch.tensor(st.step_size, dtype=u_dtype).item()
    ahead = [st.count for label, st in zip(sorted(OVERRIDES), steps) if label in AHEAD]
    assert ahead == [4, 4, 4] and {st.count for st in steps} == {1, 4}


@pytest.mark.parametrize("shadow", ["fp32", "bf16"])
def test_ema_over_every_key_matches_jax(shadow):
    """The EMA of the tree's UNet factors (fp32 masters, the text encoder's
    left out as the trainer leaves them) in one table over all 20 keys, over
    3 steps of moving masters, against JAX's ema_update."""
    js, ts = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[shadow]
    tparams = _masters("xla")
    unet = {k: v for k, v in tparams.items() if k.startswith("unet.")}
    jstate = jema.ema_init({k: jnp.asarray(to_np(v).copy()) for k, v in unet.items()}, 0.995,
                           dtype=js)
    tstate = tema.ema_init(unet, 0.995, dtype=ts)
    for step in range(3):
        r = np.random.RandomState(50 + step)
        for k, v in tparams.items():
            v.add_(torch.from_numpy((r.randn(*v.shape) * 1e-2).astype(np.float32)))
        jstate = _jax_ema_step(jstate, {k: jnp.asarray(to_np(tparams[k]).copy()) for k in unet},
                               step, False)
        tstate = tema.ema_update(tstate, tparams, step)
        for k, v in jstate.shadow.items():
            _assert_shadow(tstate.shadow[k], v, f"step {step} {k}")
    (pair, table), = tstate.tables.items()
    assert pair == (ts, torch.float32) and table.keys == tuple(sorted(unet))
    assert tstate.num_updates == int(jstate.num_updates) == 3
    assert all(to_torch(v).dtype == ts for v in jstate.shadow.values())
