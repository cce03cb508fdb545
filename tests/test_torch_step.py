"""The port's training step against the JAX package on the CPU.

Five checks, each on the same inputs in both packages:
* NoiseSchedule tables, q-sample, targets and min-SNR weights;
* the counter-hash dither and the SR bits, bit for bit;
* AdamW updates with bf16 moments (nu stored by SR): SR bits exact, 1 bf16
  ulp elsewhere;
* compute_loss and its gradients, with the JAX draws injected, loss and
  gradients within 1e-3 relative;
* one whole train step against ``make_train_step(..., pack_spec=None)``
  (the port does not pack leaves into slabs), with AdamW (bf16 moments):
  masters within 1 bf16 ulp, moments within 1 bf16 ulp of each tensor's
  largest entry; and with AdamW8bit (``SSDT_INT8_FUSED_MIN`` lowered so
  tiny leaves take int8 moments): masters within 1 bf16 ulp plus 1 ulp of
  the bf16 update, int8 moments compared after dequantization.
JAX cannot hand its random stream to torch, so the port receives the JAX
draws (noise, timesteps, offset, octaves) through ``Draws``.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.diffusion.schedule import NoiseSchedule as JSchedule
from scal_sdt_tpu.models.clip import CLIPTextConfig
from scal_sdt_tpu.models.unet import UNetConfig as JUNetConfig, unet_param_shapes
from scal_sdt_tpu.models.vae import VAEConfig
from scal_sdt_tpu.training import ema as jema
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training import step as jstep

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.convert.from_jax import opt_state_from_jax, params_from_jax
from scal_sdt_tpu_torch.diffusion.schedule import NoiseSchedule as TSchedule
from scal_sdt_tpu_torch.models.unet import UNetConfig as TUNetConfig
from scal_sdt_tpu_torch.ops import sr as tema
from scal_sdt_tpu_torch.training import optim_targets as ttargets
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training import quantized as tq
from scal_sdt_tpu_torch.training import step as tstep

from torch_port_helpers import assert_bf16_ulp, bf16_ulp, rand_unet_params, to_np


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32).transpose(0, 3, 1, 2).copy())


def _f32(x):
    """numpy float32 of a JAX array or torch tensor (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --- 1. NoiseSchedule -------------------------------------------------------

@pytest.mark.parametrize("pred,ztsnr", [("epsilon", False), ("v", False), ("sample", False),
                                        ("v", True)])
def test_noise_schedule_matches_jax(pred, ztsnr):
    js = JSchedule(prediction_type=pred, rescale_zero_terminal_snr=ztsnr)
    ts = TSchedule(prediction_type=pred, rescale_zero_terminal_snr=ztsnr)
    np.testing.assert_array_equal(ts.alphas_cumprod, js.alphas_cumprod)
    r = np.random.RandomState(0)
    x0 = r.randn(3, 4, 4, 4).astype(np.float32)
    eps = r.randn(3, 4, 4, 4).astype(np.float32)
    t = np.array([0, 500, 998], np.int32)
    tt = torch.from_numpy(t.astype(np.int64))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _f32(ts.add_noise(_nchw(x0), _nchw(eps), tt)).transpose(0, 2, 3, 1),
        _f32(js.add_noise(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))), **tol)
    np.testing.assert_allclose(
        _f32(ts.training_target(_nchw(x0), _nchw(eps), tt)).transpose(0, 2, 3, 1),
        _f32(js.training_target(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))), **tol)
    if not ztsnr:  # min-SNR divides by SNR, which is 0 at the ZTSNR terminal step
        np.testing.assert_allclose(_f32(ts.min_snr_weight(tt, 5.0)),
                                   _f32(js.min_snr_weight(jnp.asarray(t), 5.0)), rtol=1e-6)


# --- 2. dither and SR bits ----------------------------------------------------

@pytest.mark.parametrize("step,salt", [(0, 0), (1, zlib.crc32(b"unet.conv_in.weight") ^ 0xE3A0001),
                                       (77777, 0xFFFFFFFF), (2 ** 31 + 5, 0xE3A0003)])
def test_dither_and_sr_bits_are_exact(step, salt):
    shape = (5, 3, 3, 7)
    want = np.asarray(jema.cheap_dither_u32(shape, jnp.asarray(step, jnp.uint32), salt))
    got = tema.cheap_dither_u32(shape, step, salt, "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tema.cheap_dither_u16(shape, step, salt, "cpu").numpy().astype(np.uint16),
        np.asarray(jema.cheap_dither_u16(shape, jnp.asarray(step, jnp.uint32), salt)))
    x = (np.random.RandomState(step % 1000).randn(*shape) * 3).astype(np.float32)
    x.flat[:4] = [0.0, -0.0, 1.0, -2.5]  # exact bf16 values pass through
    want_sr = np.asarray(jema.stochastic_round_bf16_cheap(
        jnp.asarray(x), jnp.asarray(step, jnp.uint32), salt)).view(np.uint16)
    got_sr = tema.stochastic_round_bf16_cheap(torch.from_numpy(x), step, salt)
    np.testing.assert_array_equal(got_sr.view(torch.int16).numpy().view(np.uint16), want_sr)


# --- 3. one Adam update -------------------------------------------------------

def _opt_config(package, **optimizer):
    opt = {"name": "adamw", "master_dtype": "bf16", "moment_dtype": "bf16",
           "params": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.999, "weight_decay": 1e-2,
                      "eps": 1e-8},
           "lr_scale": {"enabled": False}}
    opt.update(optimizer)
    return package.merge(package.default(), package.Config({
        "batch_size": 2, "trainer": {"precision": "32"}, "optimizer": opt}))


def _jax_moments(state, name):
    """{key: leaf} of the mu or nu dicts in a JAX multi_transform state."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        names = [getattr(p, "name", None) for p in path]
        keys = [getattr(p, "key", None) for p in path]
        if name in names and isinstance(keys[-1], str):
            out[keys[-1]] = leaf
    return out


def test_adam_update_with_bf16_moments_matches_jax():
    r = np.random.RandomState(3)
    shapes = {"unet.a.weight": (64, 48), "unet.a.bias": (64,), "unet.b.weight": (8, 4, 3, 3)}
    labels = {k: "g0" for k in shapes}
    params_np = {k: r.randn(*s).astype(np.float32) * 0.3 for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params_np.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    jtx, _ = jopt.build_optimizer(_opt_config(jconf), labels, {}, 100, 1)
    ttx, _ = topt.build_optimizer(_opt_config(tconf), labels, {}, 100, 1)
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        # bf16 gradients, as the bf16 compute copy produces; values spanning
        # magnitudes so nu's SR store sees inexact fp32 values
        grads_np = {k: (r.randn(*s) * 10.0 ** r.uniform(-4, 0, s)).astype(np.float32)
                    for k, s in shapes.items()}
        jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads_np.items()}
        tg = params_from_jax({k: np.asarray(v) for k, v in jg.items()}, device="cpu")
        ju, jstate = jtx.update(jg, jstate, jp)
        tu, tstate = ttx.update(tg, tstate, tp)
        jmu, jnu = _jax_moments(jstate, "mu"), _jax_moments(jstate, "nu")
        for k in shapes:
            np.testing.assert_allclose(_f32(tu[k]), _f32(ju[k]), rtol=2e-6, atol=1e-12)
            assert tstate["g0"].mu[k].dtype == torch.bfloat16
            assert_bf16_ulp(tstate["g0"].mu[k], jmu[k], f"mu {k} step {i}")
            assert_bf16_ulp(tstate["g0"].nu[k], jnu[k], f"nu {k} step {i}")
        # carry identical state forward so each update is compared alone
        tstate["g0"].mu.update(params_from_jax({k: np.asarray(v) for k, v in jmu.items()},
                                               device="cpu"))
        tstate["g0"].nu.update(params_from_jax({k: np.asarray(v) for k, v in jnu.items()},
                                               device="cpu"))


def test_optimizer_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        topt.build_optimizer(_opt_config(tconf, name="lion"), {"w": "g0"}, {}, 10, 1)
    assert topt._adam_moment_dtype("mixed", True) == (torch.bfloat16, torch.float32)
    assert topt._adam_moment_dtype(None, True) == (torch.float32, torch.float32)
    assert topt._adam_moment_dtype(None, False) is None


# --- 4. compute_loss and its gradients ------------------------------------------

LOSS_EXTRAS = {"loss": {"min_snr_gamma": 5.0, "noise_offset": 0.1,
                        "multires_noise_iterations": 2, "multires_noise_discount": 0.3},
               "prior_preservation": {"enabled": True, "prior_loss_weight": 0.5}}


def _specs(extra: dict, pred="epsilon"):
    cfg = {"trainer": {"precision": "32"}, **extra}
    jcfg = jconf.merge(jconf.default(), jconf.Config(cfg))
    tcfg = tconf.merge(tconf.default(), tconf.Config(cfg))
    jspec = jstep.StepSpec.from_config(jcfg, JUNetConfig.tiny(), CLIPTextConfig.tiny(),
                                       VAEConfig.tiny(), train_text_encoder=False,
                                       schedule=JSchedule(prediction_type=pred))
    tspec = tstep.StepSpec.from_config(tcfg, TUNetConfig.tiny(),
                                       schedule=TSchedule(prediction_type=pred))
    return jspec, tspec


def _jax_draws(rng, spec, latents_shape):
    """The draws JAX's compute_loss makes from `rng`, NCHW for the port."""
    b, h, w, c = latents_shape
    dt = spec.compute_dtype
    _, _, rng_noise, rng_t, _ = jax.random.split(rng, 5)
    noise = jax.random.normal(rng_noise, latents_shape, dtype=dt)
    offset, octaves = None, []
    if spec.noise_offset:
        rng_noise, rng_off = jax.random.split(rng_noise)
        offset = jax.random.normal(rng_off, (b, 1, 1, c), dtype=dt)
    if spec.multires_noise_iterations:
        rng_noise, rng_mn = jax.random.split(rng_noise)
        for i in range(1, spec.multires_noise_iterations + 1):
            hi, wi = max(1, h // 2 ** i), max(1, w // 2 ** i)
            rng_mn, k = jax.random.split(rng_mn)
            octaves.append(jax.random.normal(k, (b, hi, wi, c), dt))
            if hi == 1 and wi == 1:
                break
    t = spec.schedule.sample_timesteps(rng_t, b)
    return tstep.Draws(noise=_nchw(noise), timesteps=torch.from_numpy(np.asarray(t, np.int64)),
                       offset=None if offset is None else _nchw(offset),
                       octaves=tuple(_nchw(o) for o in octaves))


@pytest.fixture(scope="module")
def tiny_unet():
    params = rand_unet_params(unet_param_shapes(JUNetConfig.tiny()), prefix="unet.")
    r = np.random.RandomState(5)
    batch = {"latents": r.randn(4, 8, 8, 4).astype(np.float32),
             "conds": r.randn(4, 7, 32).astype(np.float32)}
    return params, batch


def test_compute_loss_and_grads_match_jax(tiny_unet):
    """v-prediction with every loss extra on: min-SNR, noise offset,
    multires noise, prior preservation."""
    params, batch = tiny_unet
    jspec, tspec = _specs(LOSS_EXTRAS, pred="v")
    rng = jax.random.PRNGKey(11)
    jtrain = {k: jnp.asarray(v) for k, v in params.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = jax.value_and_grad(jstep.compute_loss, has_aux=True)
    (jloss, _), jgrads = jax.jit(lambda p, b, r: loss_fn(p, {}, b, r, jspec))(jtrain, jbatch, rng)

    ttrain = {k: v.requires_grad_(True) for k, v in params_from_jax(params, device="cpu").items()}
    tbatch = {"latents": _nchw(batch["latents"]), "conds": torch.from_numpy(batch["conds"])}
    draws = _jax_draws(rng, jspec, batch["latents"].shape)
    tloss, _ = tstep.compute_loss(ttrain, {}, tbatch, None, tspec, draws)
    tloss.backward()

    assert abs(tloss.item() - float(jloss)) / abs(float(jloss)) < 1e-3
    for k in params:
        assert _rel(ttrain[k].grad, jgrads[k]) < 1e-3, k


# --- 5. one whole step ----------------------------------------------------------

def _check_adamw_state(tnew, jnew, ttrain, params, labels):
    jmu, jnu = _jax_moments(jnew.opt_state, "mu"), _jax_moments(jnew.opt_state, "nu")
    for k in params:
        assert_bf16_ulp(tnew.trainable[k], jnew.trainable[k], f"master {k}")
        group = tnew.opt_state[labels[k]]
        assert _rel(group.mu[k], jmu[k]) <= 2.0 ** -7, f"mu {k}"
        # moments carry the bf16 gradient, whose fp32 sums ran in another
        # order before the bf16 store: near-zero entries differ by many of
        # their own ulps, so moments are held to one ulp of the tensor's scale
        assert _rel(group.nu[k], jnu[k]) <= 2.0 ** -7, f"nu {k}"


def _check_adamw8bit_state(tnew, jnew, ttrain, params, labels):
    jstate = opt_state_from_jax(jnew.opt_state, device="cpu")
    for k in params:
        # The update arrives in bf16 (the gradient's dtype) and the two
        # packages' gradients differ by ~1e-3, so the updates may be one bf16
        # ulp apart: the masters are held to one ulp of the new value plus
        # one ulp of the update (new - old)
        got, want, old = (to_np(x) for x in (tnew.trainable[k], jnew.trainable[k], ttrain[k]))
        slack = bf16_ulp(np.maximum(np.abs(got - old), np.abs(want - old)))
        assert_bf16_ulp(got, want, f"master {k}", slack=slack)
        got, want = tnew.opt_state[labels[k]], jstate[labels[k]]
        assert got.count == want.count == 1
        for q, s in (("mu_q", "mu_s"), ("nu_q", "nu_s")):
            gq, wq = getattr(got, q)[k], getattr(want, q)[k]
            if k in want.mu_s:
                gs, ws = getattr(got, s)[k], getattr(want, s)[k]
                lead, nb = ws.shape
                gd = tq._dequantize_leaf(gq.view(lead, nb, -1), gs.view(lead, nb, 1))
                wd = tq._dequantize_leaf(wq.view(lead, nb, -1), ws.view(lead, nb, 1))
                # the gradients agree to ~1e-3, so a payload may sit one
                # quantization step (scale) away
                step = ws.view(lead, nb, 1).expand_as(wd)
                assert (torch.abs(gd - wd) <= 1.01 * step + 1e-3 * wd.abs()).all(), f"{q} {k}"
                np.testing.assert_allclose(to_np(gs), to_np(ws), rtol=2e-2, atol=1e-30)
            else:
                # fp32 moments carry the ~1e-3 gradient differences
                assert torch.abs(gq - wq).max() <= 2e-2 * wq.abs().max() + 1e-30, f"{q} {k}"


@pytest.mark.parametrize("optimizer", ["adamw", "bitsandbytes.optim.AdamW8bit"])
def test_train_step_matches_jax(tiny_unet, optimizer, monkeypatch):
    params, batch = tiny_unet
    int8 = optimizer != "adamw"
    if int8:
        # leaves of 1024 elements and more take int8 moments, in both packages
        monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "1024")
    cfg_j, cfg_t = _opt_config(jconf, name=optimizer), _opt_config(tconf, name=optimizer)
    keys = [k[len("unet."):] for k in params]
    labels_j = jtargets.group_labels(jtargets.resolve_optim_target(
        jconf.load_optim_target("full_unet"), keys, []))
    labels_t = ttargets.group_labels(ttargets.resolve_optim_target(
        tconf.load_optim_target("full_unet"), keys, []))
    assert labels_t == labels_j

    # JAX: bf16 masters, bf16 (or int8) moments, fp32 compute, no slab packing
    jspec, tspec = _specs({})
    jtx, jlr = jopt.build_optimizer(cfg_j, labels_j, {}, 1000, 1)
    jtrain = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    # the same bf16 masters for the port, taken before JAX donates its own
    ttrain = params_from_jax({k: np.asarray(v) for k, v in jtrain.items()}, device="cpu")
    rng = jax.random.PRNGKey(1)
    jstate = jstep.init_train_state(rng, dict(jtrain), jtx, ema_enabled=False, ema_decay=0.99)
    jfn = jstep.make_train_step(jspec, jtx, jlr, ema_enabled=False, donate=False, pack_spec=None)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    ttx, tlr = topt.build_optimizer(cfg_t, labels_t, {}, 1000, 1)
    tstate = tstep.init_train_state(ttrain, ttx, seed=0)
    if int8:
        # the port's initial state has the JAX layout, leaf for leaf
        init = opt_state_from_jax(jstate.opt_state, device="cpu")
        for label, s in tstate.opt_state.items():
            assert set(s.mu_s) == set(init[label].mu_s)
            assert {k: v.shape for k, v in s.mu_q.items()} == {
                k: v.shape for k, v in init[label].mu_q.items()}
        n_int8 = sum(len(s.mu_s) for s in tstate.opt_state.values())
        assert 10 < n_int8 < len(params) // 2
    jnew, jmetrics = jfn(jstate, {}, jbatch)

    tfn = tstep.make_train_step(tspec, ttx, tlr)
    tbatch = {"latents": _nchw(batch["latents"]), "conds": torch.from_numpy(batch["conds"])}
    draws = _jax_draws(jax.random.fold_in(rng, 0), jspec, batch["latents"].shape)
    tnew, tmetrics = tfn(tstate, {}, tbatch, draws)

    assert tnew.step == int(jnew.step) == 1
    loss_j = float(jmetrics["train_loss"])
    assert abs(float(tmetrics["train_loss"]) - loss_j) / loss_j < 1e-3
    assert tmetrics["lr"] == pytest.approx(float(jmetrics["lr"]), rel=1e-6)
    assert all(tnew.trainable[k].dtype == torch.bfloat16 for k in params)
    check = _check_adamw8bit_state if int8 else _check_adamw_state
    check(tnew, jnew, ttrain, params, labels_t)
    changed = sum(int(not torch.equal(tnew.trainable[k], ttrain[k])) for k in params)
    assert changed > len(params) // 2
