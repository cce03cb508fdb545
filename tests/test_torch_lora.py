"""The port's LoRA (``models/functional.py`` delta and dropout,
``training/lora.py``, the ``lora:`` branch of ``training/optim_targets.py``)
against the JAX package's, on the CPU.

* The delta on ``linear`` and on a 1x1 ``conv2d`` (NCHW here, NHWC in JAX;
  the delta runs over the channel axis), alpha 8 at rank 4, without dropout
  and at rate 0.25 with JAX's keep masks
  (``bernoulli(fold_in(rng, crc32(name)), 1 - rate, x.shape)``, transposed
  to NCHW for the conv) injected: fp32 within 1e-5 of the output's largest
  entry, bf16 within one bf16 ulp of it (the products' sums run in another
  order).
* ``init_lora_params``: JAX's shapes, dtypes and truncated int32 alphas
  (``alpha: 0.5`` stores 0); A ~ N(0, 1/in) from the generator, B = 0.
  ``merge_lora_into_base`` within 1e-6 of the largest entry (fp32 sums in
  another order), bf16 weights within one bf16 ulp.
* ``resolve_targets`` on every shipped ``lora*.yaml`` but the SDXL and SD3
  ones, over SD1.5's UNet and CLIP keys: the same trainable keys, groups,
  LoRA specs and group labels as JAX; a ``text_encoder_2`` section resolves
  over a second tower's keys and raises without one, as in JAX.
* ``compute_loss`` of a tiny UNet with LoRA at dropout 0.25, JAX's masks
  for every layer injected through ``Draws.lora_masks`` (with its noise and
  timesteps): loss and gradients within 1e-3 relative, the tolerance of
  ``tests/test_torch_step.py``.
* Remat under dropout: the gradients of a tiny UNet with LoRA on its
  attention and 1x1 projections at dropout 0.1 are equal, bit for bit, with
  ``remat: True`` and ``False`` from the same generator seed; with the masks
  drawn from one shared generator (what a recompute under
  ``torch.utils.checkpoint`` would redraw differently) they are not.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.models import clip as jclip
from scal_sdt_tpu.models import functional as J
from scal_sdt_tpu.models import unet as junet
from scal_sdt_tpu.training import lora as jlora
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training import step as jstep

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule
from scal_sdt_tpu_torch.models import functional as T
from scal_sdt_tpu_torch.models.unet import UNetConfig
from scal_sdt_tpu_torch.training import lora as tlora
from scal_sdt_tpu_torch.training import optim_targets as ttargets
from scal_sdt_tpu_torch.training import step as tstep

from torch_port_helpers import bf16_ulp, jax_draws, rand_unet_params, to_np, to_torch

NAME = "blk.proj"


@pytest.fixture(autouse=True)
def _clear_dropout_rates():
    yield
    J.set_lora_dropout_rates({})
    T.set_lora_dropout_rates({})


def _lora_inputs(kind: str, dtype, seed: int = 0):
    """(x NHWC or (B, L, C), params) as numpy, fp32; alpha 8 at rank 4."""
    r = np.random.RandomState(seed)
    if kind == "linear":
        x, w = r.randn(2, 5, 12), r.randn(7, 12) / np.sqrt(12)
    else:
        x, w = r.randn(2, 4, 3, 12), r.randn(7, 12, 1, 1) / np.sqrt(12)
    params = {f"{NAME}.weight": w, f"{NAME}.bias": r.randn(7) * 0.1,
              f"{NAME}.lora_A": r.randn(4, 12) / np.sqrt(12), f"{NAME}.lora_B": r.randn(7, 4) * 0.5}
    cast = lambda a: jnp.asarray(a, dtype)
    return cast(x), {**{k: cast(v) for k, v in params.items()},
                     f"{NAME}.lora_alpha": jnp.asarray(8, jnp.int32)}


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["linear", "conv1x1"])
def test_lora_delta_matches_jax(kind, dtype, rate):
    x, jp = _lora_inputs(kind, getattr(jnp, dtype))
    tp = {k: to_torch(v) for k, v in jp.items()}
    conv = kind == "conv1x1"
    tx = to_torch(x).permute(0, 3, 1, 2).contiguous() if conv else to_torch(x)
    if rate:
        J.set_lora_dropout_rates({NAME: rate})
        T.set_lora_dropout_rates({NAME: rate})
        rng = jax.random.PRNGKey(11)
        jp[J.LORA_DROPOUT_RNG] = rng
        keep = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(rng, zlib.crc32(NAME.encode())), 1.0 - rate, x.shape))
        assert 0 < keep.mean() < 1
        mask = torch.from_numpy((keep.transpose(0, 3, 1, 2) if conv else keep).copy())
        tp[T.LORA_DROPOUT] = T.LoRADropout(masks={NAME: mask})
    if conv:
        want = np.asarray(J.conv2d(jp, NAME, x, padding=0), np.float32)
        got = to_np(T.conv2d(tp, NAME, tx, padding=0)).transpose(0, 2, 3, 1)
    else:
        want = np.asarray(J.linear(jp, NAME, x), np.float32)
        got = to_np(T.linear(tp, NAME, tx))
    # the delta is a real part of the output
    base = {k: v for k, v in tp.items() if "lora" not in k and k != T.LORA_DROPOUT}
    plain = (T.conv2d(base, NAME, tx, padding=0) if conv else T.linear(base, NAME, tx))
    assert np.abs(to_np(plain) - (got.transpose(0, 3, 1, 2) if conv else got)).max() > 0.1
    peak = np.abs(want).max()
    tol = 1e-5 * peak if dtype == "float32" else bf16_ulp(peak)
    assert np.abs(got - want).max() <= tol


def test_dropout_is_off_without_the_step_and_seeded_per_layer():
    """Rates alone drop nothing (inference: no LORA_DROPOUT in the dict);
    a LoRADropout's mask is a function of (base seed, layer name)."""
    x, jp = _lora_inputs("linear", jnp.float32)
    tp = {k: to_torch(v) for k, v in jp.items()}
    tx = to_torch(x)
    plain = T.linear(tp, NAME, tx)
    T.set_lora_dropout_rates({NAME: 0.5})
    assert torch.equal(T.linear(tp, NAME, tx), plain)
    a, b, c = T.LoRADropout(5), T.LoRADropout(5), T.LoRADropout(6)
    assert torch.equal(a.keep(NAME, tx, 0.5), b.keep(NAME, tx, 0.5))
    assert not torch.equal(a.keep(NAME, tx, 0.5), c.keep(NAME, tx, 0.5))
    assert not torch.equal(a.keep(NAME, tx, 0.5), a.keep("other", tx, 0.5))
    tp[T.LORA_DROPOUT] = a
    assert not torch.equal(T.linear(tp, NAME, tx), plain)


# --- factors ----------------------------------------------------------------------

SPECS = {"l": (8, 0.5), "c": (4, 8.9)}   # path: (rank, alpha)


def _base(dtype=np.float32):
    r = np.random.RandomState(3)
    return {"l.weight": (r.randn(24, 40) * 0.1).astype(dtype),
            "c.weight": (r.randn(16, 12, 1, 1) * 0.1).astype(dtype)}


def test_init_lora_params_matches_jax_layout():
    specs_j = {p: jtargets.LoRASpec(rank=r, alpha=a) for p, (r, a) in SPECS.items()}
    specs_t = {p: ttargets.LoRASpec(rank=r, alpha=a) for p, (r, a) in SPECS.items()}
    base = _base()
    want = jlora.init_lora_params(jax.random.PRNGKey(0), base, specs_j)
    tbase = {k: torch.from_numpy(v) for k, v in base.items()}
    got = tlora.init_lora_params(torch.Generator().manual_seed(0), tbase, specs_t)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
    assert int(got["l.lora_alpha"]) == int(want["l.lora_alpha"]) == 0     # int(0.5)
    assert int(got["c.lora_alpha"]) == int(want["c.lora_alpha"]) == 8     # int(8.9)
    assert not got["l.lora_B"].any() and not got["c.lora_B"].any()
    a = got["l.lora_A"]
    assert abs(float(a.std()) * np.sqrt(40) - 1.0) < 0.2
    again = tlora.init_lora_params(torch.Generator().manual_seed(0), tbase, specs_t)
    assert torch.equal(again["l.lora_A"], a)
    with pytest.raises(ValueError, match="Linear or 1x1 Conv"):
        tlora.lora_factor_shapes({"k.weight": torch.zeros(4, 4, 3, 3)},
                                 {"k": ttargets.LoRASpec()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_into_base_matches_jax(dtype):
    r = np.random.RandomState(4)
    base = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in _base().items()}
    base.update({"l.lora_A": jnp.asarray(r.randn(8, 40), jnp.float32),
                 "l.lora_B": jnp.asarray(r.randn(24, 8) * 0.1, jnp.float32),
                 "l.lora_alpha": jnp.asarray(4, jnp.int32),
                 "c.lora_A": jnp.asarray(r.randn(4, 12), jnp.float32),
                 "c.lora_B": jnp.asarray(r.randn(16, 4) * 0.1, jnp.float32)})
    want = jlora.merge_lora_into_base({k: np.asarray(v) for k, v in base.items()})
    got = tlora.merge_lora_into_base({k: to_torch(v) for k, v in base.items()})
    assert got.keys() == want.keys() == {"l.weight", "c.weight"}
    for k, v in want.items():
        g, w = to_np(got[k]), to_np(v)
        assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype), k
        tol = 1e-6 * np.abs(w).max() if dtype == "float32" else bf16_ulp(np.abs(w))
        assert (np.abs(g - w) <= tol).all(), k


# --- optim targets -------------------------------------------------------------------

LORA_TARGETS = ["lora", "lora_no-te", "lora_custom_diffusion"]


def _spec_tuple(spec):
    return (spec.rank, spec.alpha, spec.dropout)


def _sd15_keys():
    return (list(junet.unet_param_shapes(junet.UNetConfig.sd15())),
            list(jclip.clip_param_shapes(jclip.CLIPTextConfig.vit_l())))


@pytest.mark.parametrize("name", LORA_TARGETS)
def test_resolve_lora_targets_matches_jax(name):
    unet_keys, clip_keys = _sd15_keys()
    want = jtargets.resolve_optim_target(jconf.load_optim_target(name), unet_keys, clip_keys)
    got = ttargets.resolve_optim_target(tconf.load_optim_target(name), unet_keys, clip_keys)
    assert got.keys() == want.keys()
    for comp in want:
        w, g = want[comp], got[comp]
        assert g.trainable == w.trainable, comp
        assert [(x.keys, dict(x.optimizer)) for x in g.groups] == \
            [(x.keys, dict(x.optimizer)) for x in w.groups], comp
        assert {p: _spec_tuple(s) for p, s in g.lora.items()} == \
            {p: _spec_tuple(s) for p, s in w.lora.items()}, comp
    assert ttargets.group_labels(got) == jtargets.group_labels(want)
    if name == "lora":   # 16 modules in each of 12 transformer blocks; 6 per CLIP layer
        assert len(got["unet"].lora) == 192 and len(got["text_encoder"].lora) == 72
        assert len(got["unet"].groups) == 192


def test_text_encoder_2_section_still_raises():
    """A text_encoder_2 section resolves over a second tower's keys, as JAX
    resolves it (tests/test_torch_sdxl.py holds lora_sdxl over SDXL's keys),
    and still raises, as in JAX, for a model without one."""
    unet_keys, clip_keys = _sd15_keys()
    spec = tconf.load_optim_target("lora_sdxl")
    got = ttargets.resolve_optim_target(spec, unet_keys, clip_keys, clip_keys)
    want = jtargets.resolve_optim_target(jconf.load_optim_target("lora_sdxl"), unet_keys,
                                         clip_keys, text_encoder_2_keys=clip_keys)
    assert got["text_encoder_2"].trainable == want["text_encoder_2"].trainable
    assert len(got["text_encoder_2"].lora) == 72
    assert ttargets.group_labels(got) == jtargets.group_labels(want)
    with pytest.raises(ValueError, match="text_encoder_2"):
        ttargets.resolve_optim_target(spec, unet_keys, clip_keys)


# --- remat under dropout -----------------------------------------------------------------

def _lora_unet(seed: int = 0):
    """A tiny UNet (frozen, fp32) with rank-4 LoRA factors (B nonzero, so A
    takes gradients) on every attention projection and the 1x1 proj_in /
    proj_out, and the spec of its LoRA modules."""
    cfg = UNetConfig.tiny()
    base = {k: torch.from_numpy(v) for k, v in
            rand_unet_params(junet.unet_param_shapes(junet.UNetConfig.tiny()), seed).items()}
    paths = sorted(k[:-len(".weight")] for k in base
                   if k.endswith(".weight") and (".to_" in k or ".proj_" in k))
    assert any(base[f"{p}.weight"].ndim == 4 for p in paths)   # 1x1 conv projections
    specs = {p: ttargets.LoRASpec(rank=4, alpha=4, dropout=0.1) for p in paths}
    lora = tlora.init_lora_params(torch.Generator().manual_seed(seed), base, specs)
    for k in lora:
        if k.endswith(".lora_B"):
            lora[k] = torch.randn(lora[k].shape, generator=torch.Generator().manual_seed(1)) * 0.1
    trainable = {f"unet.{k}": v for k, v in lora.items() if not k.endswith("alpha")}
    frozen = {f"unet.{k}": v for k, v in {**base, **lora}.items() if f"unet.{k}" not in trainable}
    r = torch.Generator().manual_seed(2)
    batch = {"latents": torch.randn(2, 4, 16, 16, generator=r),
             "conds": torch.randn(2, 7, cfg.cross_attention_dim, generator=r)}
    return cfg, trainable, frozen, batch, specs


def _grads(remat, cfg, trainable, frozen, batch):
    spec = tstep.StepSpec(unet_config=cfg, schedule=NoiseSchedule(), compute_dtype=torch.float32,
                          remat=remat)
    return tstep.loss_and_grads(spec, trainable, frozen, batch,
                                torch.Generator().manual_seed(9))


def test_remat_gradients_equal_under_dropout(monkeypatch):
    cfg, trainable, frozen, batch, specs = _lora_unet()
    T.set_lora_dropout_rates({p: s.dropout for p, s in specs.items()})
    loss0, g0 = _grads(False, cfg, trainable, frozen, batch)
    loss1, g1 = _grads(True, cfg, trainable, frozen, batch)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(g1[k], g0[k]) for k in g0)
    assert all(g0[k].abs().max() > 0 for k in g0)
    T.set_lora_dropout_rates({})
    _, g_off = _grads(False, cfg, trainable, frozen, batch)
    assert not all(torch.equal(g_off[k], g0[k]) for k in g0)    # the dropout did drop

    # masks from one shared generator: the recompute redraws them differently
    T.set_lora_dropout_rates({p: s.dropout for p, s in specs.items()})
    shared = torch.Generator().manual_seed(0)

    def keep_shared(self, name, x, rate):
        return torch.rand(x.shape, generator=shared) < 1.0 - rate

    monkeypatch.setattr(T.LoRADropout, "keep", keep_shared)
    _, s0 = _grads(False, cfg, trainable, frozen, batch)
    shared.manual_seed(0)
    _, s1 = _grads(True, cfg, trainable, frozen, batch)
    assert not all(torch.equal(s1[k], s0[k]) for k in s0)


def test_compute_loss_with_lora_dropout_matches_jax(monkeypatch):
    """JAX draws each layer's mask from ``fold_in(rng_lora, crc32(name))``;
    the port takes those masks (NCHW for the 1x1 convs) through
    ``Draws.lora_masks``, with JAX's noise and timesteps."""
    cfg, trainable, frozen, batch, specs = _lora_unet()
    rate = 0.25
    rates = {p: rate for p in specs}
    J.set_lora_dropout_rates(rates)
    T.set_lora_dropout_rates(rates)
    jcfg = jconf.merge(jconf.default(), jconf.Config({"trainer": {"precision": "32"}}))
    jspec = jstep.StepSpec.from_config(jcfg, junet.UNetConfig.tiny(), jclip.CLIPTextConfig.tiny(),
                                       None, train_text_encoder=False)
    tspec = tstep.StepSpec(unet_config=cfg, schedule=NoiseSchedule(),
                           compute_dtype=torch.float32)
    latents = batch["latents"].permute(0, 2, 3, 1).numpy()     # NHWC for JAX
    rng = jax.random.PRNGKey(21)
    draws = jax_draws(rng, jspec, latents.shape)

    # the layer inputs' shapes, from one port forward that drops nothing
    shapes = {}

    def record(self, name, x, r):
        shapes[name] = tuple(x.shape)
        return torch.ones(x.shape, dtype=torch.bool)

    with monkeypatch.context() as m:
        m.setattr(T.LoRADropout, "keep", record)
        draws.lora_masks = {}
        tstep.compute_loss(trainable, frozen, batch, None, tspec, draws)
    assert set(shapes) == set(specs)
    rng_lora = jax.random.split(rng, 5)[4]
    masks = {}
    for name, shape in shapes.items():
        jshape = (shape[0], shape[2], shape[3], shape[1]) if len(shape) == 4 else shape
        keep = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(rng_lora, zlib.crc32(name.encode())), 1.0 - rate, jshape))
        masks[name] = torch.from_numpy((keep.transpose(0, 3, 1, 2) if len(shape) == 4
                                        else keep).copy())
    assert 0.6 < float(np.mean([m.float().mean() for m in masks.values()])) < 0.9
    draws.lora_masks = masks

    jtrain = {k: jnp.asarray(to_np(v)) for k, v in trainable.items()}
    jfrozen = {k: jnp.asarray(to_np(v)) for k, v in frozen.items()}
    jbatch = {"latents": jnp.asarray(latents), "conds": jnp.asarray(batch["conds"].numpy())}
    loss_fn = jax.value_and_grad(jstep.compute_loss, has_aux=True)
    (jloss, _), jgrads = jax.jit(lambda p, f, b, r: loss_fn(p, f, b, r, jspec))(
        jtrain, jfrozen, jbatch, rng)
    ttrain = {k: v.clone().requires_grad_(True) for k, v in trainable.items()}
    tloss, _ = tstep.compute_loss(ttrain, frozen, batch, None, tspec, draws)
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) / abs(float(jloss)) < 1e-3
    for k, g in jgrads.items():
        want = np.asarray(g)
        err = np.abs(to_np(ttrain[k].grad) - want).max() / np.abs(want).max()
        assert err < 1e-3, k
    draws.lora_masks = {k: torch.ones_like(v) for k, v in masks.items()}
    plain, _ = tstep.compute_loss(trainable, frozen, batch, None, tspec, draws)
    assert abs(plain.item() - tloss.item()) > 1e-4 * abs(tloss.item())   # the masks dropped
