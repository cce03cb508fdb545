"""Every optimizer family of the port against the JAX package's chain on the
CPU.

The same numpy-seeded masters and bf16 gradients (the dtype the train
step's bf16 compute copy gives) go through JAX's ``build_optimizer`` chain
(``tx.update``, run eagerly: each operation rounded on its own, as the port
rounds; plain ``optax.scale_by_adam`` under ``jax.jit``, as the JAX trainer
runs it, since the port rounds that chain as XLA fuses it) and the port's,
over 3 steps, two param groups (the second with its own lr). Both sides'
updates are applied by the train step's rule (fp32 masters add; bf16
masters add in fp32 and round stochastically, salted per leaf). Tolerances:

* SGD, Lion, Adam (every moment dtype and master dtype; with no moment dtype
  and fp32 masters against jitted JAX): updates, masters and moments bit for
  bit. So is AdamW's default path (fp32 masters, no moment dtype, decay on)
  against jitted ``tx.update``; against the JAX trainer's jitted update
  program, which also contracts the master apply ``p + step * u`` into an
  fma, its masters are within 1 fp32 ulp of each tensor's largest entry per
  step (the port rounds ``step * u`` before the add, as ``update`` then
  ``apply_updates`` must).
* Adafactor: the means and the block RMS add in another order, and
  ``x ** -0.5`` agrees with XLA's pow to one ulp in about 1e-3 of the
  elements; the decay then cancels the scaled update in places: updates
  within 1e-6 of each tensor's largest entry and statistics within 4e-6
  relative (fp32 masters), 1 bf16 ulp of the largest entry (bf16 masters);
  masters within 1e-6 of their largest entry (fp32) or 1 bf16 ulp.
* Prodigy and D-Adapt AdamW reduce over the whole group in another order
  (difference (r)): ``estim_lr`` within 1e-5 relative (fp32) or 2 bf16 ulps
  (bf16) after 3 steps, 12 for Prodigy with fp32 masters (whose estimate
  first grows at the 12th step of these inputs); moments and masters within
  1e-4 of each tensor's largest entry (fp32) or 2 bf16 ulps of it (bf16).
* Lion under ``jax.jit``: XLA contracts ``(1-b1) g + b1 mu`` into an FMA and
  keeps the bf16 product ``(1-b1) g`` in fp32, so the sign flips where the
  sum is within a few bf16 ulps of ``(1-b1) g`` of 0 (difference (q)): at
  most 2e-3 of the elements differ (1.2e-3 on these inputs), each by 2 lr.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.training import ema as jema
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import packing as jpacking

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.convert.from_jax import params_from_jax
from scal_sdt_tpu_torch.training import families as tfam
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import packing as tpacking
from scal_sdt_tpu_torch.training.step import apply_updates

from torch_port_helpers import bf16_ulp, to_np, to_torch

# two groups; a factored (>= 128 on two axes) matrix, a factored 4-D conv,
# small leaves that pack into slabs, and a leaf that stays natural
SHAPES = {"unet.a.weight": (160, 136), "unet.a.bias": (160,), "unet.b.weight": (8, 4, 3, 3),
          "unet.c.weight": (48, 40), "unet.c.bias": (48,), "unet.d.weight": (144, 128, 1, 1),
          "unet.e.norm": (96,)}
LABELS = {"unet.a.weight": "g0", "unet.a.bias": "g0", "unet.b.weight": "g0",
          "unet.c.weight": "g1", "unet.c.bias": "g1", "unet.d.weight": "g0",
          "unet.e.norm": "g1"}
OVERRIDES = {"g1": {"lr": 3e-3}}
PACK_MIN = 1 << 14          # the small leaves pack, the (160,136) and (144,128,1,1) do not
LR = {"adamw": 1e-3, "adam": 1e-3, "sgd": 1e-2, "lion": 1e-4, "adafactor": 1e-2,
      "prodigy": 1.0, "dadaptation.dadaptadam": 1.0}

ALIASES = {  # every name of scal_sdt_tpu/training/optimizers.py:36-46, by family
    "adamw": ["adamw", "torch.optim.AdamW", "bitsandbytes.optim.AdamW"],
    "adamw8bit": ["adamw8bit", "bitsandbytes.optim.AdamW8bit"],
    "adam": ["adam", "torch.optim.Adam"],
    "sgd": ["sgd", "torch.optim.SGD"],
    "lion": ["lion", "lion_pytorch.Lion", "bitsandbytes.optim.Lion"],
    "adafactor": ["adafactor", "transformers.optimization.Adafactor"],
    "prodigy": ["prodigy", "prodigyopt.Prodigy"],
    "dadapt": ["dadaptadam", "dadaptation.DAdaptAdam", "dadaptation.DAdaptAdamW",
               "dadaptation.experimental.DAdaptAdamW"],
}
PORT_CLASS = {"adamw": topt.AdamW, "adamw8bit": topt.AdamW8bit, "adam": topt.AdamW,
              "sgd": tfam.SGD, "lion": tfam.Lion, "adafactor": tfam.Adafactor,
              "prodigy": tfam.Prodigy, "dadapt": tfam.DAdaptAdamW}
JAX_STATE = {"adamw": "ScaleByAdamState", "adamw8bit": "ScaleByAdam8bitState",
             "adam": "ScaleByAdamState", "sgd": "ScaleByScheduleState",
             "lion": "ScaleByLionState", "adafactor": "FactoredState",
             "prodigy": "ProdigyState", "dadapt": "DAdaptAdamWState"}


def config(pkg, name, master="fp32", moment=None, wd=1e-2, packing=None, accumulate=1,
           **params):
    opt = {"name": name, "master_dtype": master,
           "params": {"lr": LR.get(str(name).lower(), 1.0), "beta1": 0.9, "beta2": 0.999,
                      "weight_decay": wd, "eps": 1e-8, **params},
           "lr_scale": {"enabled": False}}
    if moment is not None:
        opt["moment_dtype"] = moment
    trainer = {"precision": "bf16", "accumulate_grad_batches": accumulate}
    if packing is not None:
        trainer.update(param_packing=packing, pack_min_size=PACK_MIN)
    return pkg.merge(pkg.default(), pkg.Config({"batch_size": 2, "trainer": trainer,
                                                "optimizer": opt}))


def masters(master: str, seed: int = 0):
    """(numpy fp32 values, JAX masters, port masters) in the master dtype."""
    r = np.random.RandomState(seed)
    values = {k: (r.randn(*s) * 0.3).astype(np.float32) for k, s in SHAPES.items()}
    jdt = jnp.bfloat16 if master == "bf16" else jnp.float32
    jp = {k: jnp.asarray(v, jdt) for k, v in values.items()}
    return values, jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def bf16_grads(step: int, keys=SHAPES, seed: int = 100):
    """bf16 gradients spanning magnitudes, with a direction that persists
    from step to step (so Prodigy's and D-Adapt's estimates grow), as JAX
    arrays and port tensors."""
    drift = np.random.RandomState(seed - 1)
    r = np.random.RandomState(seed + step)
    g = {}
    for k in keys:
        mean = drift.randn(*SHAPES[k])
        g[k] = ((mean + 0.5 * r.randn(*SHAPES[k])) * 10.0 ** r.uniform(-3, 0, SHAPES[k])
                ).astype(np.float32)
    jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
    return jg, params_from_jax({k: np.asarray(v) for k, v in jg.items()}, device="cpu")


def jax_apply(jp: dict, ju: dict, step: int) -> dict:
    """The JAX train step's apply of natural leaves: fp32 masters add, bf16
    masters add in fp32 and round by SR salted crc32(key) ^ 0xE3A0001."""
    out = {}
    for k, p in jp.items():
        if p.dtype == jnp.bfloat16:
            out[k] = jema.stochastic_round_bf16_cheap(
                p.astype(jnp.float32) + ju[k].astype(jnp.float32), jnp.asarray(step, jnp.uint32),
                zlib.crc32(k.encode()) ^ 0xE3A0001)
        else:
            out[k] = (p + ju[k].astype(p.dtype)).astype(p.dtype)
    return out


def jax_leaves(state, field: str) -> dict:
    """{key: array} of a field (mu, v_row, exp_avg...) anywhere in a JAX
    optimizer state; other groups' masked placeholders are skipped."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [getattr(p, "name", None) for p in path]
        key = getattr(path[-1], "key", None)
        if field in names and isinstance(key, str) and hasattr(leaf, "shape"):
            out[key] = leaf
    return out


def jax_scalar(state, field: str) -> dict:
    """{group label: value} of a 0-dim field (estim_lr...) per group."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [getattr(p, "name", None) for p in path]
        if names and names[-1] == field:
            label = next(getattr(p, "key") for p in path if isinstance(getattr(p, "key", None),
                                                                       str))
            out[label] = float(np.asarray(leaf).astype(np.float32))
    return out


def port_leaves(state: dict, field: str) -> dict:
    out = {}
    for s in state.values():
        out.update(getattr(s, field))
    return out


def assert_exact(got, want, what):
    got, want = to_np(got), to_np(want)
    assert got.dtype == want.dtype or what, what
    bad = got != want
    assert not bad.any(), f"{what}: {bad.sum()} of {bad.size} differ, max " \
                          f"{np.abs(got.astype(np.float64) - want).max():.3g}"


def assert_close(got, want, rel: float, what: str, bf16_ulps: float = 0.0):
    """Within ``rel`` of the tensor's largest entry, or ``bf16_ulps`` bf16
    ulps of it when given."""
    got, want = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    bound = bf16_ulps * bf16_ulp(scale) if bf16_ulps else rel * scale
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max error {err:.3g} > {bound:.3g} (largest {scale:.3g})"


def _same_dtype(got, want, what):
    assert str(to_torch(want).dtype) == str(got.dtype), \
        f"{what}: {got.dtype} in the port, {want.dtype} in JAX"


def _state_types(node) -> set:
    """The names of every named tuple inside a JAX optimizer state."""
    out = {type(node).__name__} if hasattr(node, "_fields") else set()
    children = node.values() if isinstance(node, dict) else (
        node if isinstance(node, (tuple, list)) else ())
    for child in children:
        out |= _state_types(child)
    return out


# --- names ----------------------------------------------------------------------

@pytest.mark.parametrize("family,name", [(f, n) for f, names in ALIASES.items() for n in names])
def test_every_name_builds_its_family(family, name):
    jtx, _ = jopt.build_optimizer(config(jconf, name), LABELS, OVERRIDES, 100, 1)
    ttx, _ = topt.build_optimizer(config(tconf, name), LABELS, OVERRIDES, 100, 1)
    assert {type(t) for t in ttx.transforms.values()} == {PORT_CLASS[family]}
    _, jp, _ = masters("fp32")
    assert JAX_STATE[family] in _state_types(jtx.init(jp))
    if family == "adam":  # no decay in the chain, whatever weight_decay says
        assert all(t.weight_decay == 0.0 for t in ttx.transforms.values())


def test_unknown_optimizer_raises_and_adam_moment_dtypes_hold():
    with pytest.raises(ValueError, match="Unknown optimizer: rmsprop"):
        topt.build_optimizer(config(tconf, "rmsprop"), LABELS, {}, 10, 1)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        jopt.build_optimizer(config(jconf, "rmsprop"), LABELS, {}, 10, 1)


# --- each family over 3 steps ---------------------------------------------------------

CASES = ([("adam", m, md) for m in ("fp32", "bf16") for md in (None, "bf16", "mixed")]
         + [("lion", m, md) for m in ("fp32", "bf16") for md in (None, "bf16", "mixed", "fp16")]
         + [("sgd", m, None) for m in ("fp32", "bf16")]
         + [("sgd_no_decay", "fp32", None)]
         + [("prodigy", m, None) for m in ("fp32", "bf16")]
         + [("prodigy_safeguard", "fp32", None)]
         + [("dadaptation.dadaptadam", m, None) for m in ("fp32", "bf16")])

EXTRA = {"prodigy_safeguard": ("prodigy", {"safeguard_warmup": True, "d_coef": 2.0,
                                           "beta3": 0.98, "d0": 1e-5}),
         "sgd_no_decay": ("sgd", {"weight_decay": 0.0})}


def _jax_jits(name, master, moment) -> bool:
    """Whether the JAX chain is plain ``optax.scale_by_adam`` (AdamW / Adam,
    fp32 masters, no moment dtype), compared under ``jax.jit``."""
    return name in ("adam", "adamw") and master == "fp32" and moment is None


def _run_both(name, master, moment, steps=3, packing=None, **params):
    """3 steps of both packages from the same masters and gradients; yields
    (step, JAX updates, port updates, JAX state, port state, JAX masters,
    port masters) after each step. With ``packing`` the JAX side runs on the
    packed dict (``pack`` -> ``tx`` -> ``unpack``), as the JAX trainer does.
    Plain ``scale_by_adam`` runs under ``jax.jit`` (``_jax_jits``)."""
    values, jp, tp = masters(master)
    jcfg = config(jconf, name, master, moment, packing=packing, **params)
    tcfg = config(tconf, name, master, moment, packing=packing, **params)
    jspec = tspec = None
    jlabels = dict(LABELS)
    if packing:
        jspec = jpacking.build_pack_spec(values, LABELS, min_slab_size=PACK_MIN, stack_big=False)
        tspec = tpacking.build_pack_spec({k: torch.from_numpy(v) for k, v in values.items()},
                                         LABELS, min_slab_size=PACK_MIN, stack_big=False)
        assert jspec.slabs and tspec == jspec
        jlabels = {**{k: v for k, v in LABELS.items() if k not in jspec.packed_keys},
                   **jpacking.packed_labels(jspec)}
    jtx, _ = jopt.build_optimizer(jcfg, jlabels, OVERRIDES, 100, 1)
    ttx, _ = topt.build_optimizer(tcfg, dict(LABELS), OVERRIDES, 100, 1, pack_spec=tspec)

    def packed(d):
        if jspec is None:
            return d
        out = {k: v for k, v in d.items() if k not in jspec.packed_keys}
        for slab_key, padded, slots in jspec.slabs:
            dt = d[slots[0].key].dtype
            parts = [jnp.ravel(d[s.key]) for s in slots]
            parts.append(jnp.zeros((padded - sum(s.size for s in slots),), dt))
            out[slab_key] = jnp.concatenate(parts)
        return out

    jstate, tstate = jtx.init(packed(jp)), ttx.init(tp)
    jupdate = jax.jit(jtx.update) if _jax_jits(name, master, moment) else jtx.update
    for i in range(steps):
        jg, tg = bf16_grads(i)
        ju, jstate = jupdate(packed(jg), jstate, packed(jp))
        if jspec is not None:
            ju = {k: jnp.asarray(v) for k, v in jpacking.unpack_host(
                {k: np.asarray(v) for k, v in ju.items()}, jspec).items()}
        tu, tstate = ttx.update(tg, tstate, tp)
        jp = jax_apply(jp, ju, i)
        tp = apply_updates(tp, tu, i)
        yield i, ju, tu, jstate, tstate, jp, tp


@pytest.mark.parametrize("case,master,moment", CASES)
def test_family_matches_jax_over_three_steps(case, master, moment):
    name, params = EXTRA.get(case, (case, {}))
    exact = name in ("sgd", "lion", "adam")
    # Prodigy's estimate first grows at the 12th step of these inputs (fp32)
    steps = 12 if case == "prodigy" and master == "fp32" else 3
    for i, ju, tu, jstate, tstate, jp, tp in _run_both(name, master, moment, steps, **params):
        for k in SHAPES:
            _same_dtype(tu[k], ju[k], f"update {k}")
            what = f"{case} step {i} {k}"
            if exact:
                assert_exact(tu[k], ju[k], f"update {what}")
                assert_exact(tp[k], jp[k], f"master {what}")
            elif master == "fp32":
                assert_close(tp[k], jp[k], 1e-4, f"master {what}")
            else:
                assert_close(tp[k], jp[k], 0, f"master {what}", bf16_ulps=2)
        if name in ("lion", "adam"):
            for field in ("mu",) + (("nu",) if name == "adam" else ()):
                jm, tm = jax_leaves(jstate, field), port_leaves(tstate, field)
                for k in SHAPES:
                    _same_dtype(tm[k], jm[k], f"{field} {k}")
                    assert_exact(tm[k], jm[k], f"{field} {case} step {i} {k}")
        if name in ("prodigy", "dadaptation.dadaptadam"):
            j_est = jax_scalar(jstate, "estim_lr")
            for label, s in tstate.items():
                _same_dtype(s.estim_lr, jnp.zeros((), jnp.bfloat16 if master == "bf16"
                                                  else jnp.float32), "estim_lr")
                got = float(s.estim_lr.float())
                if master == "fp32":
                    assert got == pytest.approx(j_est[label], rel=1e-5), (label, i)
                else:
                    assert abs(got - j_est[label]) <= 2 * bf16_ulp(j_est[label]), (label, i)
            for field in ("exp_avg", "exp_avg_sq", "grad_sum"):
                jm, tm = jax_leaves(jstate, field), port_leaves(tstate, field)
                for k in SHAPES:
                    _same_dtype(tm[k], jm[k], f"{field} {k}")
                    if master == "fp32":
                        assert_close(tm[k], jm[k], 1e-4, f"{field} {case} step {i} {k}")
                    else:
                        assert_close(tm[k], jm[k], 0, f"{field} {case} step {i} {k}",
                                     bf16_ulps=2)
    if case in ("prodigy", "dadaptation.dadaptadam") and master == "fp32":
        # the estimate moved in both packages: the comparison is not of d0
        assert float(tstate["g0"].estim_lr.float()) > float(params.get("d0", 1e-6)) * 1.04


def test_adamw_default_path_matches_jax_jitted_step():
    """AdamW with fp32 masters and no moment dtype (the default config) over
    3 steps, two groups, decay on: ``update`` and the moments bit for bit
    against jitted ``tx.update``; the train step's ``update_and_apply``
    against the JAX trainer's update program (``tx.update`` then the apply,
    in one ``jax.jit``): XLA contracts ``p + step * u`` into one fma where
    the port rounds ``step * u`` first, so the masters are held to 1 fp32
    ulp of each tensor's largest entry per step (about 1.2e-7 of it; 4.5e-8
    measured after the first step)."""
    for i, ju, tu, jstate, tstate, jp, tp in _run_both("adamw", "fp32", None):
        for k in SHAPES:
            _same_dtype(tu[k], ju[k], f"update {k}")
            assert_exact(tu[k], ju[k], f"update step {i} {k}")
            assert_exact(tp[k], jp[k], f"master step {i} {k}")
        for field in ("mu", "nu"):
            jm, tm = jax_leaves(jstate, field), port_leaves(tstate, field)
            for k in SHAPES:
                assert_exact(tm[k], jm[k], f"{field} step {i} {k}")

    values, jp, tp = masters("fp32")
    jtx, _ = jopt.build_optimizer(config(jconf, "adamw"), LABELS, OVERRIDES, 100, 1)
    ttx, _ = topt.build_optimizer(config(tconf, "adamw"), LABELS, OVERRIDES, 100, 1)
    assert all(t.xla for t in ttx.transforms.values())

    @jax.jit
    def jax_update_program(params, state, grads):
        updates, state = jtx.update(grads, state, params)
        return {k: (p + updates[k].astype(p.dtype)).astype(p.dtype)
                for k, p in params.items()}, state

    jstate, tstate = jtx.init(jp), ttx.init(tp)
    differ = total = 0
    for i in range(3):
        jg, tg = bf16_grads(i)
        jp, jstate = jax_update_program(jp, jstate, jg)
        tstate = ttx.update_and_apply(tg, tstate, tp, i)
        for k in SHAPES:
            want = to_np(jp[k]).astype(np.float64)
            ulp = float(np.spacing(np.float32(np.abs(want).max())))
            err = np.abs(to_np(tp[k]).astype(np.float64) - want)
            assert err.max() <= (i + 1) * ulp, f"master step {i} {k}: {err.max():.3g}"
            differ += int((err > 0).sum())
            total += err.size
        for field in ("mu", "nu"):
            jm, tm = jax_leaves(jstate, field), port_leaves(tstate, field)
            for k in SHAPES:
                assert_exact(tm[k], jm[k], f"{field} step {i} {k}")
    assert differ < total // 4, f"{differ} of {total} masters differ"


@pytest.mark.parametrize("master,packing", [("fp32", True), ("fp32", False), ("bf16", True),
                                            ("bf16", False)])
def test_adafactor_matches_jax_packed_and_not(master, packing):
    """Under JAX's default packing the small leaves form slabs: unfactored,
    one RMS clip per slab (padding counted), where per-leaf optax would
    factor the (48,40)... leaves' neighbours and clip each leaf on its own."""
    for i, ju, tu, jstate, tstate, jp, tp in _run_both("adafactor", master, None,
                                                       packing=packing):
        for k in SHAPES:
            _same_dtype(tu[k], ju[k], f"update {k}")
            what = f"step {i} {k}"
            if master == "fp32":
                assert_close(tu[k], ju[k], 1e-6, f"update {what}")
            else:
                assert_close(tu[k], ju[k], 0, f"update {what}", bf16_ulps=1)
            if master == "fp32":
                assert_close(tp[k], jp[k], 1e-6, f"master {what}")
            else:
                assert_close(tp[k], jp[k], 0, f"master {what}", bf16_ulps=1)
        # the statistics, per block under JAX's keys
        for field in ("v_row", "v_col", "v"):
            jm, tm = jax_leaves(jstate, field), port_leaves(tstate, field)
            assert set(jm) == set(tm), field
            for k in jm:
                _same_dtype(tm[k], jm[k], f"{field} {k}")
                if master == "fp32":
                    np.testing.assert_allclose(to_np(tm[k]), to_np(jm[k]), rtol=4e-6, atol=1e-30)
                else:
                    assert_close(tm[k], jm[k], 0, f"{field} {k}", bf16_ulps=1)
    blocks = {b.key: b for s in [None] for b in tfam.adafactor_blocks(
        sorted(SHAPES), SHAPES, tpacking.build_pack_spec(
            {k: torch.zeros(s) for k, s in SHAPES.items()}, LABELS, PACK_MIN, False)
        if packing else None)}
    kinds = sorted(b.kind for b in blocks.values())
    assert kinds == (["leaf", "leaf", "slab", "slab"] if packing else ["leaf"] * 7)


def test_lion_under_jit_differs_only_at_ties():
    """The trainer jits JAX's update: XLA fuses ``(1-b1) g + b1 mu`` (an FMA,
    the bf16 product kept in fp32), so a sign flips where the sum is within
    a few ulps of 0. Elsewhere the update is bit for bit the port's."""
    values, jp, tp = masters("fp32")
    jtx, _ = jopt.build_optimizer(config(jconf, "lion", "bf16"), LABELS, OVERRIDES, 100, 1)
    ttx, _ = topt.build_optimizer(config(tconf, "lion", "bf16"), LABELS, OVERRIDES, 100, 1)
    jupdate = jax.jit(jtx.update)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    flips = total = 0
    for i in range(3):
        jg, tg = bf16_grads(i)
        ju, jstate = jupdate(jg, jstate, jp)
        tu, tstate = ttx.update(tg, tstate, tp)
        for k in SHAPES:
            lr = LR["lion"] if LABELS[k] == "g0" else OVERRIDES["g1"]["lr"]
            diff = np.abs(to_np(tu[k]).astype(np.float64) - to_np(ju[k]))
            bad = diff > 0
            flips += int(bad.sum())
            total += diff.size
            assert np.all(diff[bad] <= 2 * lr * (1 + 1e-6)), k
        # carry JAX's momentum so each step's flips are counted alone
        for k, v in jax_leaves(jstate, "mu").items():
            port_leaves(tstate, "mu")[k].copy_(to_torch(v))
    assert 0 < flips <= 2e-3 * total, f"{flips} of {total} signs flipped"


def test_prodigy_params0_is_a_copy():
    """The train step updates the masters in place: an aliased params0
    would make ``p0 - p`` zero for ever and the estimate would never grow."""
    _, _, tp = masters("fp32")
    ttx, _ = topt.build_optimizer(config(tconf, "prodigy"), LABELS, {}, 100, 1)
    state = ttx.init(tp)
    first = {k: v.clone() for k, v in tp.items()}
    for label, s in state.items():
        for k, p0 in s.params0.items():
            assert p0.data_ptr() != tp[k].data_ptr()
    for i in range(12):
        _, tg = bf16_grads(i)
        state = ttx.update_and_apply(tg, state, tp, i)
    for s in state.values():
        for k, p0 in s.params0.items():
            assert torch.equal(p0, first[k])
            assert not torch.equal(tp[k], first[k])
        assert float(s.estim_lr) > 1e-6 * 1.04


@pytest.mark.parametrize("name,master", [("adam", "bf16"), ("lion", "bf16"), ("sgd", "fp32"),
                                         ("adafactor", "fp32"), ("prodigy", "bf16"),
                                         ("dadaptation.dadaptadam", "fp32")])
def test_update_and_apply_is_update_then_apply(name, master):
    """The train step's entry equals ``update`` then ``apply_updates``, bit
    for bit, for the new families (the Adam families have their own test in
    test_torch_optim_fused.py)."""
    _, _, tp_a = masters(master)
    _, _, tp_b = masters(master)
    cfg = config(tconf, name, master, packing=True)
    spec = tpacking.build_pack_spec({k: torch.zeros(s) for k, s in SHAPES.items()}, LABELS,
                                    PACK_MIN, False)
    tx, _ = topt.build_optimizer(cfg, LABELS, OVERRIDES, 100, 1, pack_spec=spec)
    sa, sb = tx.init(tp_a), tx.init(tp_b)
    for i in range(3):
        _, tg = bf16_grads(i)
        sa = tx.update_and_apply(tg, sa, tp_a, i)
        u, sb = tx.update(tg, sb, tp_b)
        tp_b = apply_updates(tp_b, u, i)
    for k in SHAPES:
        assert torch.equal(tp_a[k], tp_b[k]), k


def test_accumulation_wraps_any_family():
    """Lion under ``accumulate_grad_batches: 2`` against JAX's
    ``gradient_accumulation`` over 4 micro-steps: the fp32 sums' means are
    equal, and the updates are bit for bit (JAX divides by the fp32
    reciprocal only under jit, difference (h))."""
    values, jp, tp = masters("fp32")
    jtx, _ = jopt.build_optimizer(config(jconf, "lion", accumulate=2), LABELS, OVERRIDES, 100, 1)
    ttx, _ = topt.build_optimizer(config(tconf, "lion", accumulate=2), LABELS, OVERRIDES, 100, 1)
    assert isinstance(ttx, topt.GradientAccumulation)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(4):
        jg, tg = bf16_grads(i)
        ju, jstate = jtx.update(jg, jstate, jp)
        jp = jax_apply(jp, ju, i)
        tstate = ttx.update_and_apply(tg, tstate, tp, i)
        for k in SHAPES:
            assert_exact(tp[k], jp[k], f"master step {i} {k}")
    assert tstate.mini == 0 and all(s.count == 2 for s in tstate.inner.values())


@pytest.mark.parametrize("name", ["prodigy", "dadaptation.dadaptadam"])
def test_a_group_without_gradient_gets_nan_as_in_jax(name):
    """optax's Prodigy and D-Adapt divide by the group's summed |grad_sum|:
    a group whose gradients are all zero (the LoRA factors of a CLIP layer
    that CLIP-skip drops) gets estim_lr = 0/0 = NaN in the JAX package, and
    the port keeps that behaviour rather than departing from the reference."""
    shapes = {"unet.z.weight": (4, 3), "unet.z.bias": (4,)}
    labels = {k: "g0" for k in shapes}
    jp = {k: jnp.ones(s, jnp.float32) for k, s in shapes.items()}
    tp = {k: torch.ones(s) for k, s in shapes.items()}
    jtx, _ = jopt.build_optimizer(config(jconf, name), labels, {}, 100, 1)
    ttx, _ = topt.build_optimizer(config(tconf, name), labels, {}, 100, 1)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for _ in range(2):
        ju, jstate = jtx.update({k: jnp.zeros_like(v) for k, v in jp.items()}, jstate, jp)
        tu, tstate = ttx.update({k: torch.zeros_like(v) for k, v in tp.items()}, tstate, tp)
    assert np.isnan(jax_scalar(jstate, "estim_lr")["g0"])
    assert torch.isnan(tstate["g0"].estim_lr)
    for k in shapes:
        assert np.array_equal(np.isnan(to_np(tu[k])), np.isnan(np.asarray(ju[k]))), k
