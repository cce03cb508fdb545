"""The port's Trainer and train CLI against the JAX package's, on the CPU.

* The whole slice: both Trainers on one tiny diffusers directory and config
  for 3 steps, uncached (images through the VAE and prompts through CLIP,
  fp32 masters and moments) and cached (a cache the JAX cache CLI wrote,
  bf16 masters and moments), the JAX draws injected into the port
  (``draws_fn``). Exactly equal: trainable and frozen key sets, dtypes and
  group labels. Per-step losses within 1e-5 relative; final masters and
  moments within the whole-step tolerances (fp32: 1e-4 of each tensor's
  largest entry, the drift of three Adam steps on gradients that agree to
  ~1e-6; bf16: one ulp, as ROADMAP difference (a)); the checkpoints the two
  write: the same names, keys, dtypes and metadata, values as the state.
  JAX runs its mesh over the 8 virtual CPU devices (data 8), the port on
  one device; sums run in another order, so nothing here is bit for bit.
* Gradient accumulation against the JAX ``gradient_accumulation``
  (k = 2, 3; AdamW and AdamW8bit; bf16 masters, so the emit-step SR bits
  are checked): masters still on non-emit micro-steps, at most one bf16
  ulp from JAX after an emit; the accumulated step equals the port's step
  on the mean bit for bit; the schedule counts optimizer steps; the
  trainer moves the masters on emit steps only.
* Behaviour: the NaN tripwire, the SIGTERM autosave, SSDT_STEP_TIMINGS and
  the profiler trace, the ``xformers`` switch, the configs that need later
  slices (and those of items 1.12, 1.13 and 1.15, which build now).
* The CLI with ``--device cpu``: run dir and ``config.yaml`` snapshot, the
  usage and config errors, ``--resume`` from the snapshot.
"""

import json
import os
import signal
import zlib

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax
import jax.numpy as jnp

from scal_sdt_tpu import conf as jconf
from scal_sdt_tpu.cli import cache as jcache
from scal_sdt_tpu.training import ema as jema
from scal_sdt_tpu.training import optim_targets as jtargets
from scal_sdt_tpu.training import optimizers as jopt
from scal_sdt_tpu.training.trainer import Trainer as JTrainer
from scal_sdt_tpu.utils import state as jstate

from scal_sdt_tpu_torch import conf as tconf
from scal_sdt_tpu_torch.cli import train as tcli
from scal_sdt_tpu_torch.convert.from_jax import opt_state_from_jax
from scal_sdt_tpu_torch.ops import attention as tattention
from scal_sdt_tpu_torch.training import optimizers as topt
from scal_sdt_tpu_torch.training.trainer import Trainer as TTrainer
from scal_sdt_tpu_torch.utils import state as tstate

from helpers import make_image_dataset
from test_torch_data import write_vocab
from torch_port_helpers import (assert_bf16_ulp, bf16_ulp, jax_draws, nchw, tiny_model_dir,
                                tiny_sd3_dir, tiny_sdxl_dir, to_np, to_torch)

BATCH, IMAGES, RES = 8, 16, 32      # 2 steps per epoch: 3 steps cross an epoch
LATENTS = (BATCH, RES // 2, RES // 2, 4)   # the tiny VAE downsamples 2x


@pytest.fixture(autouse=True)
def _restore_attention_gate():
    yield
    tattention.FORCE_MATH = False


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny model directory with a CLIP-BPE vocab, 16 captioned images, a
    cache of them that the JAX cache CLI wrote, and the shared config."""
    tmp = tmp_path_factory.mktemp("trainer")
    model = tiny_model_dir(tmp / "model")
    write_vocab(model / "tokenizer")
    data = make_image_dataset(tmp, n=IMAGES)
    user = {"model": str(model), "output_dir": str(tmp / "out"), "batch_size": BATCH,
            "seed": 3, "num_workers": 2,
            "data": {"resolution": RES, "concepts": [
                {"instance_set": {"path": str(data), "prompt": "{TXT_PROMPT}"}}]},
            "trainer": {"precision": "32", "max_epochs": 2},
            "optimizer": {"params": {"lr": 1e-3}, "lr_scale": {"enabled": False}},
            "checkpoint": {"filename": "{epoch}-{step}", "every_n_epochs": None}}
    cache_cfg = dict(user, data=dict(user["data"], cache=str(tmp / "cache.safetensors")))
    (tmp / "cache.yaml").write_text(json.dumps(cache_cfg))
    result = CliRunner().invoke(jcache.main, ["--config", str(tmp / "cache.yaml"),
                                              "--batch-size", "8", "--aug-group-size", "1"])
    assert result.exit_code == 0, result.output or repr(result.exception)
    return tmp, user


SLICE_CASES = {
    "uncached-fp32": ({}, False),
    "cached-bf16": ({"optimizer": {"master_dtype": "bf16", "moment_dtype": "bf16"}}, True),
}


def _configs(user, tmp, extra, cached):
    cfg = jconf.merge(user, extra)
    if cached:
        cfg = jconf.merge(cfg, {"data": {"cache": str(tmp / "cache.safetensors")}})
    jcfg = jconf.merge(jconf.default(), cfg,
                        {"trainer": {"mesh": {"data": 8}, "param_packing": False}})
    tcfg = tconf.merge(tconf.default(), tconf.Config(dict(cfg)))
    return jcfg, tcfg


def _capture_losses(trainer, monkeypatch):
    losses = []
    real = trainer._log

    def log(metrics, step):
        losses.append((step, metrics["train_loss"]))
        real(metrics, step)

    monkeypatch.setattr(trainer, "_log", log)
    return losses


def _port_draws(rng, jspec, cached):
    """JAX's draws at fold_in(state.rng, step), for the port's ``fit``."""
    def draws_fn(step):
        key = jax.random.fold_in(rng, step)
        d = jax_draws(key, jspec, LATENTS)
        if not cached:
            rng_latent = jax.random.split(key, 5)[0]
            d.latent_noise = nchw(jax.random.normal(rng_latent, LATENTS, jnp.float32))
        return d
    return draws_fn


def _rel(a, b):
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _check_masters(got: dict, want: dict, bf16: bool, lr: float, steps: int):
    """Masters of two runs of ``steps`` Adam steps at ``lr``: within one bf16
    ulp (bf16) or 1e-4 of the tensor's largest entry (fp32) in all but 1e-3
    of the elements. The rest are elements whose gradient is near zero, so
    that its sign may differ between the packages' sums; Adam moves such an
    element by about lr either way, so they are held to 2 * lr * steps."""
    far, total = 0, 0
    for k in want:
        g, w = to_np(got[k]).astype(np.float64), to_np(want[k]).astype(np.float64)
        d = np.abs(g - w)
        close = (bf16_ulp(np.maximum(np.abs(g), np.abs(w))) if bf16
                 else 1e-4 * np.abs(w).max())
        assert (d <= close + 2 * lr * steps).all(), k
        far += int((d > close).sum())
        total += d.size
    assert far <= 1e-3 * total, f"{far} of {total} masters beyond the close bound"


@pytest.mark.parametrize("case", list(SLICE_CASES))
def test_trainer_matches_jax(tiny_run, case, monkeypatch):
    tmp, user = tiny_run
    extra, cached = SLICE_CASES[case]
    jcfg, tcfg = _configs(user, tmp, extra, cached)
    jtr = JTrainer(jcfg, tmp / case / "jax")
    ttr = TTrainer(tcfg, tmp / case / "port", device="cpu")

    # the partition, dtypes and groups, exactly
    jnat, tnat = jtr.natural_trainable(), ttr.natural_trainable()
    assert tnat.keys() == jnat.keys() and ttr.frozen.keys() == jtr.frozen.keys()
    for ours, theirs in ((tnat, jnat), (ttr.frozen, jtr.frozen)):
        for k, v in theirs.items():
            assert str(ours[k].dtype).removeprefix("torch.") == \
                {"float32": "float32", "bfloat16": "bfloat16"}[str(v.dtype)], k
    assert ttr.tx.labels == jtargets.group_labels(jtr.resolutions)
    for k in jnat:
        assert torch.equal(tnat[k], to_torch(jnat[k])), k

    rng0 = np.asarray(jtr.state.rng)
    jlosses, tlosses = _capture_losses(jtr, monkeypatch), _capture_losses(ttr, monkeypatch)
    jtr.fit(max_steps_override=3)
    ttr.fit(max_steps_override=3, draws_fn=_port_draws(rng0, jtr.spec, cached))
    assert [s for s, _ in tlosses] == [s for s, _ in jlosses] == [1, 2, 3]
    for (_, t), (_, j) in zip(tlosses, jlosses):
        assert abs(t - j) <= 1e-5 * abs(j), (tlosses, jlosses)

    bf16 = "bf16" in case
    jnat, tnat = jtr.natural_trainable(), ttr.natural_trainable()
    jopt_state = opt_state_from_jax(jtr.state.opt_state, device="cpu")
    _check_masters(tnat, jnat, bf16, lr=1e-3, steps=3)
    for label, group in ttr.state.opt_state.items():
        assert group.count == jopt_state[label].count == 3
        for what in ("mu", "nu"):
            for k, v in getattr(group, what).items():
                want = getattr(jopt_state[label], what)[k]
                assert v.dtype == want.dtype, (what, k)
                assert _rel(v, want) <= (2.0 ** -7 if bf16 else 1e-4), (what, k)

    # the checkpoints: names, keys, dtypes and metadata equal; values as the state
    jfiles = sorted(p.name for p in (tmp / case / "jax").glob("*.safetensors"))
    tfiles = sorted(p.name for p in (tmp / case / "port").glob("*.safetensors"))
    assert tfiles == jfiles == ["epoch=1-step=3.safetensors"]
    jpath, tpath = tmp / case / "jax" / jfiles[0], tmp / case / "port" / tfiles[0]
    assert (tpath.parent / (tpath.name + ".torchstate")).exists()
    assert tstate.load_metadata(tpath) == jstate.load_metadata(jpath)
    jfile, tfile = jstate.load_state_dict(jpath), tstate.load_state_dict(tpath)
    assert tfile.keys() == jfile.keys() == jnat.keys()
    for k, v in jfile.items():
        assert str(tfile[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert torch.equal(tfile[k], tnat[k]) and np.array_equal(to_np(v), to_np(jnat[k])), k


# --- gradient accumulation ------------------------------------------------------

ACC_SHAPES = {"unet.a.weight": (64, 320), "unet.b.weight": (8, 16), "unet.b.bias": (40,)}
OPTIMIZERS = ["adamw", "bitsandbytes.optim.AdamW8bit"]


def _acc_config(conf, k, optimizer, schedule=None):
    return conf.merge(conf.default(), conf.Config({
        "trainer": {"accumulate_grad_batches": k},
        "optimizer": {"name": optimizer, "master_dtype": "bf16",
                      "params": {"lr": 1e-2, "weight_decay": 1e-2},
                      "lr_scale": {"enabled": False},
                      "lr_scheduler": schedule or {"name": "constant", "params": {}}}}))


def _bf16_arrays(seed, scale):
    r = np.random.RandomState(seed)
    return {k: jnp.asarray(r.randn(*s) * scale, jnp.bfloat16) for k, s in ACC_SHAPES.items()}


def _jax_apply(params, updates, step):
    """The JAX step's master apply: fp32 add, SR store salted per key."""
    return {k: jema.stochastic_round_bf16_cheap(
        p.astype(jnp.float32) + updates[k].astype(jnp.float32), jnp.asarray(step, jnp.int32),
        zlib.crc32(k.encode()) ^ 0xE3A0001) for k, p in params.items()}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("k", [2, 3])
def test_gradient_accumulation_matches_jax(k, optimizer, monkeypatch):
    """2k micro-steps of bf16 gradients: the masters stay put on non-emit
    micro-steps, in both packages, and are at most one bf16 ulp from JAX's
    after each emit (the SR store seeded by the global micro-step); the
    inner counts and the logged lr count optimizer steps."""
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "1024")   # a.weight takes int8 moments
    labels = {key: "g0" for key in ACC_SHAPES}
    jtx, jlr = jopt.build_optimizer(_acc_config(jconf, k, optimizer), labels, {}, 10, 1)
    ttx, tlr = topt.build_optimizer(_acc_config(tconf, k, optimizer), labels, {}, 10, 1)
    assert isinstance(ttx, topt.GradientAccumulation) and ttx.k == k
    jparams = _bf16_arrays(0, 0.05)
    tparams = {key: to_torch(v) for key, v in jparams.items()}
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    if optimizer != "adamw":
        assert set(tstate.inner["g0"].mu_s) == {"unet.a.weight"}
    for step in range(2 * k):
        grads = _bf16_arrays(10 + step, 1e-2)
        before = {key: v.clone() for key, v in tparams.items()}
        updates, jstate = jtx.update(grads, jstate, jparams)
        jparams = _jax_apply(jparams, updates, step)
        tstate = ttx.update_and_apply({key: to_torch(v) for key, v in grads.items()}, tstate,
                                      tparams, step)
        emit = (step + 1) % k == 0
        for key in ACC_SHAPES:
            assert torch.equal(tparams[key], before[key]) != emit, (step, key)
            assert_bf16_ulp(tparams[key], jparams[key], f"step {step} {key}")
        inner = opt_state_from_jax(jstate[1], device="cpu")["g0"]
        assert tstate.inner["g0"].count == inner.count == (step + 1) // k
        assert tstate.mini == int(jstate[0]) == (step + 1) % k
        assert tlr(step) == pytest.approx(float(jlr(jnp.asarray(step))), rel=1e-6)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("k", [2, 3])
def test_accumulated_step_is_the_step_on_the_mean(k, optimizer, monkeypatch):
    """k accumulated micro-steps give the masters and moments that one step on
    the mean of the gradients gives (their fp32 sum over a 0-dim k), bit for
    bit; the emit's SR store takes the global micro-step k - 1."""
    monkeypatch.setenv("SSDT_INT8_FUSED_MIN", "1024")
    labels = {key: "g0" for key in ACC_SHAPES}
    acc_tx, _ = topt.build_optimizer(_acc_config(tconf, k, optimizer), labels, {}, 10, 1)
    one_tx, _ = topt.build_optimizer(_acc_config(tconf, 1, optimizer), labels, {}, 10, 1)
    start = {key: to_torch(v) for key, v in _bf16_arrays(0, 0.05).items()}
    acc_p, one_p = ({key: v.clone() for key, v in start.items()} for _ in range(2))
    acc_s, one_s = acc_tx.init(acc_p), one_tx.init(one_p)
    grads = [{key: to_torch(v) for key, v in _bf16_arrays(10 + i, 1e-2).items()}
             for i in range(k)]
    for i, g in enumerate(grads):
        acc_s = acc_tx.update_and_apply(g, acc_s, acc_p, i)
    mean = {key: sum(g[key].float() for g in grads) / torch.tensor(float(k))
            for key in ACC_SHAPES}
    one_s = one_tx.update_and_apply(mean, one_s, one_p, k - 1)
    for key in ACC_SHAPES:
        assert torch.equal(acc_p[key], one_p[key]), key
        assert not acc_s.acc[key].any(), key
    for field in ("mu", "nu") if optimizer == "adamw" else ("mu_q", "mu_s", "nu_q", "nu_s"):
        for key, v in getattr(one_s["g0"], field).items():
            assert torch.equal(getattr(acc_s.inner["g0"], field)[key], v), (field, key)


def test_schedule_counts_optimizer_steps():
    """A cosine schedule over 4 optimizer steps: 4 micro-steps at k = 2 land
    where 2 plain steps do, and the logged lr of micro-step 2 is that of
    optimizer step 1 (JAX's too)."""
    labels = {key: "g0" for key in ACC_SHAPES}
    cosine = {"name": "cosine", "params": {"T_max": 4.0}}
    acc_tx, acc_lr = topt.build_optimizer(_acc_config(tconf, 2, "adamw", cosine), labels, {},
                                          1, 1)
    one_tx, one_lr = topt.build_optimizer(_acc_config(tconf, 1, "adamw", cosine), labels, {},
                                          1, 1)
    _, jlr = jopt.build_optimizer(_acc_config(jconf, 2, "adamw", cosine), labels, {}, 1, 1)
    start = {key: to_torch(v) for key, v in _bf16_arrays(0, 0.05).items()}
    acc_p, one_p = ({key: v.clone() for key, v in start.items()} for _ in range(2))
    acc_s, one_s = acc_tx.init(acc_p), one_tx.init(one_p)
    g = {key: torch.full(s, 1e-2, dtype=torch.bfloat16) for key, s in ACC_SHAPES.items()}
    for i in range(4):
        acc_s = acc_tx.update_and_apply(g, acc_s, acc_p, i)
    for i in (1, 3):   # the emits' micro-steps seed the SR store
        one_s = one_tx.update_and_apply({key: v.float() for key, v in g.items()}, one_s, one_p,
                                        i)
    for key in ACC_SHAPES:
        assert torch.equal(acc_p[key], one_p[key]), key
    assert acc_lr(2) == one_lr(1) == pytest.approx(float(jlr(jnp.asarray(2))), rel=1e-6)
    assert acc_lr(2) != acc_lr(0)


def _cached_config(tiny_run, **overrides):
    tmp, user = tiny_run
    cfg = tconf.merge(tconf.default(), tconf.Config(user),
                      tconf.Config({"data": {"cache": str(tmp / "cache.safetensors")}}))
    return tconf.merge(cfg, tconf.Config(overrides))


@pytest.mark.parametrize("micro_steps,expect_moved", [(1, False), (2, True)])
def test_trainer_moves_masters_only_on_emit(tiny_run, tmp_path, micro_steps, expect_moved):
    cfg = _cached_config(tiny_run, trainer={"accumulate_grad_batches": 2})
    trainer = TTrainer(cfg, tmp_path / "run", device="cpu")
    trainer.fit(max_steps_override=micro_steps)
    before = trainer.models.unet["conv_out.weight"]
    after = trainer.natural_trainable()["unet.conv_out.weight"]
    assert (not torch.equal(before, after)) == expect_moved
    assert trainer.state.opt_state.mini == micro_steps % 2


# --- behaviour ------------------------------------------------------------------

def test_nan_loss_trips(tiny_run, tmp_path):
    """An infinite learning rate sends the masters to inf after step 1, so
    step 2's loss is NaN and the loop stops with FloatingPointError."""
    cfg = _cached_config(tiny_run, optimizer={"params": {"lr": float("inf")}})
    trainer = TTrainer(cfg, tmp_path / "run", device="cpu")
    with pytest.raises(FloatingPointError, match="NaN loss at step 2"):
        trainer.fit(max_steps_override=4)


def test_sigterm_autosaves_and_returns(tiny_run, tmp_path):
    """SIGTERM during step 3 (sent from the step callback): the loop saves a
    checkpoint with its sidecar and loop state after the step and returns;
    the previous handler is back afterwards."""
    from scal_sdt_tpu_torch.training.checkpoint import load_loop_state

    cfg = _cached_config(tiny_run)
    trainer = TTrainer(cfg, tmp_path / "run", device="cpu")
    outer = signal.getsignal(signal.SIGTERM)

    def callback(tr, step):
        if step == 3:
            assert signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, signal.SIG_IGN)
            os.kill(os.getpid(), signal.SIGTERM)

    trainer.fit(sample_callback=callback, max_steps_override=6)
    assert trainer.global_step == 3
    ckpt = tmp_path / "run" / "epoch=1-step=3.safetensors"
    assert ckpt.exists() and (tmp_path / "run" / (ckpt.name + ".torchstate")).exists()
    assert load_loop_state(ckpt) == {"epoch": 1, "batch_in_epoch": 1}
    assert signal.getsignal(signal.SIGTERM) is outer


def test_step_timings_and_profiler_trace(tiny_run, tmp_path, monkeypatch):
    """SSDT_STEP_TIMINGS gets one JSON line per logged step with the batch
    shape in the JAX package's (B, H, W, C) order; the `profiler:` block
    writes a Chrome trace of its steps to `profiler.dir`."""
    timings = tmp_path / "timings.jsonl"
    monkeypatch.setenv("SSDT_STEP_TIMINGS", str(timings))
    prof = tmp_path / "prof"
    cfg = _cached_config(tiny_run, profiler={"enabled": True, "start_step": 1,
                                             "num_steps": 1, "dir": str(prof)})
    TTrainer(cfg, tmp_path / "run", device="cpu").fit(max_steps_override=3, final_save=False)
    lines = [json.loads(x) for x in timings.read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2, 3]
    assert all(x["shape"] == [BATCH, RES // 2, RES // 2, 4] and x["dt"] > 0 for x in lines)
    trace = json.loads((prof / "trace_step1.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("xformers", [True, False])
def test_xformers_switch_gates_the_kernels(tiny_run, tmp_path, xformers):
    """`xformers: false` sets FORCE_MATH, and the gate then refuses even a
    call the kernels take (a CUDA bf16 self-attention at L = 4096)."""
    TTrainer(_cached_config(tiny_run, xformers=xformers), tmp_path / "run", device="cpu")
    assert tattention.FORCE_MATH is (not xformers)
    shape = (8, 8, 4096, 40)
    assert tattention.use_kernel(shape, shape, torch.bfloat16, False, True) is xformers


def _model_dir(tmp_path, tiny_run, sub):
    """A tiny SDXL directory ('sdxl') or SD3 directory with T5 and its
    tokenizer_3/ ('sd3'), each with the run's vocab, or the run's SD1.x
    directory with an empty text_encoder_2/ ('sdxl_empty_te2')."""
    import shutil

    d = tmp_path / sub
    model = tiny_run[1]["model"]
    if sub in ("sdxl", "sd3"):
        tiny_sdxl_dir(d) if sub == "sdxl" else tiny_sd3_dir(d)
        shutil.copytree(f"{model}/tokenizer", d / "tokenizer")
        return str(d)
    shutil.copytree(model, d)
    (d / "text_encoder_2").mkdir()
    return str(d)


LATER_SLICES = {
    # (overrides, the error's type and text; None: the config builds)
    # items 1.12 and 1.13 are ported: these build now (TI from a cache raises
    # as in JAX)
    "ema": ({"ema": {"enabled": True}}, None),
    "lora": ({"optim_target": "lora_no-te"}, None),
    "custom_embeddings": ({"custom_embeddings": {"enabled": True}}, None),
    "textual_inversion": ({"custom_embeddings": {"train": {
        "enabled": True, "tokens": [{"keyword": "my-cat"}]}}},
        (ValueError, "live text encoding")),
    "sampling": ({"sampling": {"concepts": [{"prompt": "a cat"}], "interval_steps": 1}}, None),
    # item 1.15 is ported: an SDXL directory builds uncached; from a cache
    # it needs pooled embeddings (the run's cache is SD1.x's), and an empty
    # text_encoder_2/ raises as JAX's loader does
    "sdxl": ({"model": "sdxl", "data": {"cache": None}}, None),
    "sdxl_cache_without_pooled": ({"model": "sdxl"}, (ValueError, "pooled")),
    "sdxl_empty_text_encoder_2": ({"model": "sdxl_empty_te2"},
                                  (FileNotFoundError, "No weights file")),
    # item 1.16 is ported: an SD3 directory builds uncached (its T5 with the
    # tokenizer_3/ beside it); from a cache it needs pooled embeddings
    "sd3": ({"model": "sd3", "data": {"cache": None}}, None),
    # item 1.17 is ported: the mesh's own errors, before any process group
    "mesh_product": ({"trainer": {"mesh": {"data": 2}}}, (ValueError, "mesh 2x1x1 != 1 devices")),
    "tensor_across_hosts": ({"trainer": {"mesh": {"tensor": 2}}},
                            (NotImplementedError, "single-host")),
    "batch_not_divisible": ({}, (ValueError, "batch_size 8 is not divisible by the 3")),
}
# torchrun's environment of the cases that need one
LAUNCH_ENV = {"tensor_across_hosts": {"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "2"},
              "batch_not_divisible": {"WORLD_SIZE": "3", "LOCAL_WORLD_SIZE": "3"}}


@pytest.mark.parametrize("case", list(LATER_SLICES))
def test_later_slice_configs_raise(tiny_run, tmp_path, monkeypatch, case):
    """The configs of items 1.12 (EMA, LoRA, custom embeddings), 1.13
    (sampling concepts), 1.15 (SDXL) and 1.16 (SD3) build, and textual
    inversion from a condition cache, an SDXL run from a cache without
    pooled embeddings and an SDXL directory with an empty text_encoder_2/
    raise as the JAX trainer does; item 1.17's mesh raises for a product
    that is not the world size, a tensor axis across hosts and a batch the
    host's data-parallel ranks do not divide."""
    overrides, error = LATER_SLICES[case]
    for name, value in LAUNCH_ENV.get(case, {}).items():
        monkeypatch.setenv(name, value)
    if case == "custom_embeddings":
        (tmp_path / "emb").mkdir()
        overrides = {"custom_embeddings": {"enabled": True, "path": str(tmp_path / "emb")}}
    if "model" in overrides:
        overrides = dict(overrides, model=_model_dir(tmp_path, tiny_run, overrides["model"]))
    cfg = _cached_config(tiny_run, **overrides)
    if error is None:
        trainer = TTrainer(cfg, tmp_path / "run", device="cpu")
        # one process: the mesh of one rank
        assert trainer.mesh.shape == (1, 1, 1)
        assert (trainer.state.ema is not None) == (case == "ema")
        assert any(k.endswith(".lora_A") for k in trainer.state.trainable) == (case == "lora")
        assert (trainer.spec.sdxl or trainer.spec.sd3) == any(
            k.startswith("condition_model.encoder_2.") for k in trainer.frozen) == (
            case in ("sdxl", "sd3"))
        assert trainer.spec.sd3 == any(k.startswith("condition_model.encoder_3.")
                                       for k in trainer.frozen) == (case == "sd3")
        return
    with pytest.raises(error[0], match=error[1]):
        TTrainer(cfg, tmp_path / "run", device="cpu")


# --- the CLI ----------------------------------------------------------------------

def _cli(args):
    return CliRunner().invoke(tcli.main, args + ["--device", "cpu"])


def test_cli_trains_snapshots_and_resumes(tiny_run, tmp_path):
    """The run dir <output_dir>/<project>/<run_id> with the JAX CLI's
    config.yaml snapshot; `--resume` reloads that snapshot and goes on from
    the checkpoint's step to max_steps."""
    tmp, user = tiny_run
    cfg = dict(user, output_dir=str(tmp_path / "out"),
               data=dict(user["data"], cache=str(tmp / "cache.safetensors")),
               trainer=dict(user["trainer"], max_steps=3),
               checkpoint=dict(user["checkpoint"], every_n_train_steps=1))
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))
    result = _cli(["--config", str(path), "--run-id", "first"])
    assert result.exit_code == 0, repr(result.exception)
    run = tmp_path / "out" / "SCAL-SDT" / "first"
    snapshot = (run / "config.yaml").read_text()
    assert snapshot == jconf.to_yaml(jconf.load_with_defaults(path))
    assert sorted(p.name for p in run.glob("*.safetensors")) == [
        "epoch=0-step=1.safetensors", "epoch=0-step=2.safetensors",
        "epoch=1-step=3.safetensors"]

    result = _cli(["--resume", str(run / "epoch=0-step=2.safetensors"), "--run-id", "second"])
    assert result.exit_code == 0, repr(result.exception)
    second = tmp_path / "out" / "SCAL-SDT" / "second"
    assert (second / "config.yaml").read_text() == snapshot
    assert [p.name for p in second.glob("*.safetensors")] == ["epoch=1-step=3.safetensors"]
    for name in ("epoch=1-step=3.safetensors", "epoch=1-step=3.safetensors.torchstate"):
        want, got = (tstate.load_state_dict(d / name, "safetensors") for d in (run, second))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_cli_config_errors(tiny_run, tmp_path):
    result = _cli([])
    assert result.exit_code == 2 and "Either --config or --resume" in result.output
    tmp, user = tiny_run
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(dict(user, output_dir=str(tmp_path / "out"),
                                    data=dict(user["data"], concepts=[]))))
    result = _cli(["--config", str(path)])
    assert isinstance(result.exception, ValueError)
    assert "No concept found" in str(result.exception)
