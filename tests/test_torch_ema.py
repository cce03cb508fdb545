"""The port's EMA (``training/ema.py``, its plain grouped update
``ops/ema_fused.py``) against the JAX package's ``training/ema.py``, on the
CPU.

* The decay warm-up: ``1 - min(decay, (1 + n) / (10 + n))`` in fp32, bit for
  bit with JAX's for n = 1..200.
* ``ema_update`` over 3 steps of moving masters, one table (one launch on a
  card) over every key of the dtype pair: a bf16 shadow
  bit for bit under both dither rules (bf16 masters: the low half of the
  master SR store's hash, salt ``crc32(k) ^ 0xE3A0001``; fp32 masters: the
  high half of a hash salted ``^ 0xE3A0002``), at the train step before its
  increment; an fp32 shadow to one fp32 ulp (XLA on the CPU contracts
  ``s - (1 - d) * (s - p)`` into an fma, ROADMAP difference (d)).
* Under gradient accumulation (k = 2, bf16 masters and shadow): the EMA runs
  on every micro-step, emits or not, and stays bit-equal to JAX's; the count
  counts micro-steps.
* ``ema_state_dict`` / ``ema_from_state_dict``: the reference's layout.
* Checkpoints with an EMA shadow and LoRA factors: the port writes JAX's
  file (keys, dtypes, bits, metadata), and each package restores the other's
  shadow, decay and count.

The kernel itself is held against ``ema_fused_apply_reference`` on a card
(``tests/test_torch_kernels_cuda.py``).
"""

import json
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.training import checkpoint as jckpt
from scal_sdt_tpu.training import ema as jema
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import step as jstep
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.ops import ema_fused as EF
from scal_sdt_tpu_torch.training import checkpoint as tckpt
from scal_sdt_tpu_torch.training import ema as tema
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import step as tstep
from scal_sdt_tpu_torch.utils import state as tstate

from torch_port_helpers import to_np, to_torch

SHAPES = {"unet.a.weight": (64, 40), "unet.b.weight": (8, 4, 1, 1), "unet.b.bias": (13,),
          "unet.c.lora_A": (4, 40), "unet.c.lora_B": (24, 4)}
GROUPS = {"g0": ["unet.a.weight", "unet.c.lora_A", "unet.c.lora_B"],
          "g1": ["unet.b.bias", "unet.b.weight"]}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(seed, scale, dtype, shapes=SHAPES):
    r = np.random.RandomState(seed)
    return {k: jnp.asarray(r.randn(*s) * scale, dtype) for k, s in shapes.items()}


def _fp32_ulps(got, want) -> float:
    g, w = to_np(got).astype(np.float64), to_np(want).astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32)).astype(np.float64)
    return float((np.abs(g - w) / ulp).max())


def _assert_shadow(got: torch.Tensor, want, what: str):
    """bf16 shadows bit for bit; fp32 ones within one ulp."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), what
    if got.dtype == torch.bfloat16:
        assert torch.equal(got, to_torch(want)), what
    else:
        assert _fp32_ulps(got, want) <= 1.0, what


def _jax_ema_step(state, params, step, master_bf16):
    """The JAX step's EMA call: bf16 masters share the master SR store's hash
    (its low half goes to a bf16 shadow); otherwise the step's own hash."""
    bf16_shadow = any(v.dtype == jnp.bfloat16 for v in state.shadow.values())
    dither = None
    if bf16_shadow and master_bf16:
        dither = {k: jema.cheap_dither_u32(p.shape, jnp.asarray(step, jnp.int32),
                                           zlib.crc32(k.encode()) ^ 0xE3A0001) & jnp.uint32(0xFFFF)
                  for k, p in params.items()}
    return jema.ema_update(state, params, step=jnp.asarray(step, jnp.int32), dither=dither)


def test_decay_warmup_matches_jax():
    for decay in (0.995, 0.9999, 0.5):
        for n in range(1, 201):
            jn = jnp.asarray(n, jnp.int32)
            want = 1.0 - jnp.minimum(jnp.asarray(decay, jnp.float32), (1.0 + jn) / (10.0 + jn))
            got = np.float32(tema.one_minus_decay(decay, n))
            assert got.tobytes() == np.asarray(want, np.float32).tobytes(), (decay, n)


@pytest.mark.parametrize("master", ["fp32", "bf16"])
@pytest.mark.parametrize("shadow", ["fp32", "bf16"])
def test_ema_update_matches_jax(shadow, master):
    jm, tm = DTYPES[master]
    js, ts = DTYPES[shadow]
    jparams = _arrays(0, 0.05, jm)
    jstate_ = jema.ema_init(jparams, 0.995, dtype=js)
    tparams = {k: to_torch(v) for k, v in jparams.items()}
    tstate_ = tema.ema_init(tparams, 0.995, dtype=ts)
    assert all(tstate_.shadow[k].data_ptr() != tparams[k].data_ptr() for k in tparams)
    for step in range(3):
        moved = _arrays(10 + step, 0.05, jm)
        jparams = {k: (jparams[k].astype(jnp.float32) + moved[k].astype(jnp.float32) * 0.1
                       ).astype(jm) for k in jparams}
        for k, v in jparams.items():
            tparams[k].copy_(to_torch(v))
        jstate_ = _jax_ema_step(jstate_, jparams, step, master == "bf16")
        tstate_ = tema.ema_update(tstate_, tparams, step)
        assert tstate_.num_updates == int(jstate_.num_updates) == step + 1
        for k, v in jstate_.shadow.items():
            _assert_shadow(tstate_.shadow[k], v, f"step {step} {k}")
    (pair, table), = tstate_.tables.items()
    assert pair == (ts, tm) and table.keys == tuple(sorted(SHAPES))
    assert tstate_.decay == float(np.asarray(jstate_.decay))


def test_ema_runs_on_every_micro_step_under_accumulation(monkeypatch):
    """k = 2 over 4 micro-steps, bf16 masters and shadow, the shadow started
    off the masters: the masters move on emits only, the shadow on every
    micro-step, bit for bit with JAX's (tx.update, the SR apply, then the EMA
    on the shared hash's low half), and the count reaches 4."""
    k = 2
    cfg = {"trainer": {"accumulate_grad_batches": k},
           "optimizer": {"name": "adamw", "master_dtype": "bf16",
                         "params": {"lr": 1e-2, "weight_decay": 1e-2},
                         "lr_scale": {"enabled": False}}}
    labels = {key: "g0" if key in GROUPS["g0"] else "g1" for key in SHAPES}
    jtx, _ = jopt.build_optimizer(jconf.merge(jconf.default(), cfg), labels, {}, 10, 1)
    ttx, _ = topt.build_optimizer(tconf.merge(tconf.default(), tconf.Config(cfg)), labels, {},
                                  10, 1)
    jparams = _arrays(0, 0.05, jnp.bfloat16)
    tparams = {key: to_torch(v) for key, v in jparams.items()}
    jst, tst = jtx.init(jparams), ttx.init(tparams)
    off = _arrays(1, 0.05, jnp.bfloat16)
    jema_state = jema.ema_init(off, 0.995, dtype=jnp.bfloat16)
    tema_state = tema.ema_init({key: to_torch(v) for key, v in off.items()}, 0.995,
                               torch.bfloat16)
    for step in range(2 * k):
        grads = _arrays(10 + step, 1e-2, jnp.bfloat16)
        before = {key: v.clone() for key, v in tparams.items()}
        shadow_before = {key: v.clone() for key, v in tema_state.shadow.items()}
        updates, jst = jtx.update(grads, jst, jparams)
        jparams = {key: jema.stochastic_round_bf16_cheap(
            p.astype(jnp.float32) + updates[key].astype(jnp.float32),
            jnp.asarray(step, jnp.int32), zlib.crc32(key.encode()) ^ 0xE3A0001)
            for key, p in jparams.items()}
        jema_state = _jax_ema_step(jema_state, jparams, step, True)
        tst = ttx.update_and_apply({key: to_torch(v) for key, v in grads.items()}, tst, tparams,
                                   step)
        tema_state = tema.ema_update(tema_state, tparams, step)
        emit = (step + 1) % k == 0
        for key in SHAPES:
            assert torch.equal(tparams[key], before[key]) != emit, (step, key)
            assert torch.equal(tparams[key], to_torch(jparams[key])), (step, key)
            assert not torch.equal(tema_state.shadow[key], shadow_before[key]), (step, key)
            _assert_shadow(tema_state.shadow[key], jema_state.shadow[key], f"{step} {key}")
    assert tema_state.num_updates == int(jema_state.num_updates) == 2 * k


def test_ema_state_dict_matches_jax():
    """The reference's layout (decay, num_updates, shadow_params), both ways."""
    jparams = _arrays(0, 0.05, jnp.float32)
    jst = jema.ema_init(jparams, 0.995)._replace(num_updates=jnp.asarray(4, jnp.int32))
    tst = tema.ema_init({k: to_torch(v) for k, v in jparams.items()}, 0.995)
    tst.num_updates = 4
    jsd, tsd = jema.ema_state_dict(jst), tema.ema_state_dict(tst)
    assert tsd.keys() == jsd.keys()
    assert (tsd["decay"], tsd["num_updates"]) == (jsd["decay"], jsd["num_updates"])
    assert tsd["shadow_params"].keys() == jsd["shadow_params"].keys()
    back = tema.ema_from_state_dict(jsd)
    assert (back.decay, back.num_updates) == (tst.decay, 4)
    for k, v in jsd["shadow_params"].items():
        assert torch.equal(tsd["shadow_params"][k], torch.from_numpy(np.array(v))), k
        assert torch.equal(back.shadow[k], tst.shadow[k]), k


def test_reference_table_is_cached_and_rebuilt():
    params = {k: to_torch(v) for k, v in _arrays(0, 0.05, jnp.float32).items()}
    state = tema.ema_init(params, 0.9)
    state = tema.ema_update(state, params, 0)
    pair = (torch.float32, torch.float32)
    table = state.tables[pair]
    assert table.keys == tuple(sorted(SHAPES))
    state = tema.ema_update(state, params, 1)
    assert state.tables[pair] is table
    state.shadow["unet.a.weight"] = state.shadow["unet.a.weight"].clone()
    state = tema.ema_update(state, params, 2)
    assert state.tables[pair] is not table
    assert EF.launches["ema_fused"] == 0     # the CPU runs the plain version


@pytest.mark.parametrize("what", ["shadow", "master"])
def test_ema_table_refuses_dtypes_other_than_fp32_and_bf16(what):
    """The kernel has an instance for each pair of fp32 and bf16 (the port
    keeps masters and shadows in no other): a table of fp16 tensors is
    refused on the CPU as on a card."""
    t = {"shadow": [torch.zeros(8)], "master": [torch.zeros(8)]}
    t[what] = [t[what][0].half()]
    with pytest.raises(TypeError, match="fp32 or bf16"):
        EF.build_ema_table(["unet.a.weight"], t["shadow"], t["master"])


# --- checkpoints ----------------------------------------------------------------

STEP, NUM_UPDATES = 5, 7
CKPT_SHAPES = {**SHAPES, "condition_model.encoder.t.lora_A": (4, 16),
               "condition_model.encoder.t.lora_B": (16, 4)}
FROZEN_ALPHAS = {"unet.c.lora_alpha": 8, "condition_model.encoder.t.lora_alpha": 1}


def _opt_config(conf):
    return conf.merge(conf.default(), conf.Config({"optimizer": {"lr_scale": {"enabled": False}}}))


def _states(ema_dtype: str):
    """A port and a JAX state of the same masters (fp32), EMA shadows over the
    unet.* keys in ``ema_dtype`` at NUM_UPDATES, and the frozen LoRA alphas."""
    js, ts = DTYPES[ema_dtype]
    masters = _arrays(0, 0.05, jnp.float32, CKPT_SHAPES)
    shadow = {k: v for k, v in _arrays(1, 0.05, js, CKPT_SHAPES).items() if k.startswith("unet.")}
    labels = {k: "g0" for k in masters}
    jtx, _ = jopt.build_optimizer(_opt_config(jconf), labels, {}, 10, 1)
    ttx, _ = topt.build_optimizer(_opt_config(tconf), labels, {}, 10, 1)
    jst = jstep.TrainState(
        step=jnp.asarray(STEP, jnp.int32), trainable=dict(masters),
        opt_state=jtx.init(masters), rng=jax.random.PRNGKey(0),
        ema=jema.EMAState(shadow=dict(shadow), num_updates=jnp.asarray(NUM_UPDATES, jnp.int32),
                          decay=jnp.asarray(0.995, jnp.float32)))
    tst = tstep.init_train_state({k: to_torch(v) for k, v in masters.items()}, ttx,
                                 ema_enabled=True, ema_decay=0.995, ema_dtype=ts)
    for k, v in shadow.items():
        tst.ema.shadow[k].copy_(to_torch(v))
    tst = tst._replace(step=STEP, ema=tema.EMAState(tst.ema.shadow, NUM_UPDATES, tst.ema.decay))
    jfrozen = {k: jnp.asarray(v, jnp.int32) for k, v in FROZEN_ALPHAS.items()}
    tfrozen = {k: torch.tensor(v, dtype=torch.int32) for k, v in FROZEN_ALPHAS.items()}
    return (jst, jfrozen), (tst, tfrozen), masters, shadow


@pytest.mark.parametrize("ema_dtype", ["fp32", "bf16"])
def test_ema_and_lora_checkpoints_cross_packages(tmp_path, ema_dtype):
    (jst, jfrozen), (tst, tfrozen), masters, shadow = _states(ema_dtype)
    jpath, tpath = tmp_path / "jax" / "s.safetensors", tmp_path / "port" / "s.safetensors"
    jckpt.save_checkpoint(jpath, jst, jfrozen, loop_state={"epoch": 1, "batch_in_epoch": 2})
    tckpt.save_checkpoint(tpath, tst, tfrozen, loop_state={"epoch": 1, "batch_in_epoch": 2})

    # the same file: keys, dtypes, bits and metadata
    assert tstate.load_metadata(tpath) == jstate.load_metadata(jpath)
    meta = json.loads(tstate.load_metadata(tpath)["json"])
    assert meta["ema_num_updates"] == NUM_UPDATES and meta["ema_decay"] == float(np.float32(0.995))
    want, got = jstate.load_state_dict(jpath), jstate.load_state_dict(tpath)
    assert got.keys() == want.keys()
    assert {k for k in got if k.startswith("unet_ema.shadow_params.")} == {
        "unet_ema.shadow_params." + k[len("unet."):] for k in shadow}
    assert {k for k in got if k.endswith("lora_alpha")} == set(FROZEN_ALPHAS)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(
            np.asarray(got[k]).reshape(-1).view(np.uint8), np.asarray(v).reshape(-1).view(np.uint8)), k

    # each package restores the other's shadow, decay and count
    (jtmpl, _), (ttmpl, _), _, _ = _states(ema_dtype)
    ttmpl = ttmpl._replace(ema=tema.ema_init({k: torch.zeros_like(v) for k, v in
                                              ttmpl.ema.shadow.items()}, 0.5, DTYPES[ema_dtype][1]))
    live = dict(ttmpl.ema.shadow)
    restored = tckpt.restore_train_state(jpath, ttmpl)
    assert restored.ema.num_updates == NUM_UPDATES
    assert restored.ema.decay == float(np.float32(0.995))
    for k, v in shadow.items():
        assert restored.ema.shadow[k] is live[k] and torch.equal(live[k], to_torch(v)), k
    jtmpl = jtmpl._replace(ema=jema.ema_init({k: jnp.zeros_like(v) for k, v in shadow.items()},
                                             0.5, DTYPES[ema_dtype][0]))
    back = jckpt.restore_train_state(tpath, jtmpl)
    assert int(back.ema.num_updates) == NUM_UPDATES
    assert float(back.ema.decay) == float(np.float32(0.995))
    for k, v in shadow.items():
        assert np.array_equal(to_np(back.ema.shadow[k]), to_np(v)), k
    for k, v in masters.items():
        assert np.array_equal(to_np(back.trainable[k]), to_np(v)), k
