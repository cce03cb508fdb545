#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (scal_sdt_tpu_torch) on one NVIDIA card.

Usage, from the root of a checkout, on a machine with a Hopper card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0] [--steps 5]

Phases (any failure raises and the script exits non-zero):

1. build   -- compile the port's kernels from scal_sdt_tpu_torch/ops/csrc with
              nvcc for sm_90a (one nvcc per source, in parallel): splash fwd,
              dq, dkv; the int8 Adam update (adam8_fused); the fused Adam
              update over stored moments (adam_bf16_fused).
2. kernels -- at the main path's shapes, (8,8,4096,40) and (8,8,1024,80) bf16,
              plus the ARB length (1,8,1344,40) that no block divides: each
              splash kernel (fwd, dq, dkv) against its plain PyTorch version
              on the same inputs, then the autograd Function against autograd
              of splash_attention_reference. Bounds: forward 5e-3 max-abs,
              dq/dk/dv 1.5e-2 relative (those of the JAX splash tests). Times of
              the kernel, its plain version and torch's SDPA, and the least
              time the card could take.
3. optim   -- the optimizer kernels against their plain versions at SD1.5 leaf
              shapes: adam8_fused at (1280, 23040) and the ragged (320, 2880),
              from a state quantized by one plain step (payloads at most 1
              apart in under 1e-3 of them, scales and step within 1e-6
              relative); adam_bf16_fused at (1280, 23040) with bf16 moments
              and the nu SR store (AdamW's form) and at (320,) with fp32
              moments (the int8 path's small leaves): moments bit for bit,
              step within 1e-6 relative. Times of kernel and plain version,
              the bytes bound, and for adam_bf16_fused torch._fused_adamw_ on
              the same leaf (the nearest library call, not the same function).
4. train   -- the SD1.5 full fine-tune step at full width: 512^2 (64^2 latents),
              batch 8, cached random latents/conds from --seed, bf16 masters,
              bf16 moments, EMA off, no remat. 3 warm-up steps, then --steps
              timed steps with the launch counts reset just before: each
              splash kernel must launch 10 times per step and adam_bf16_fused
              686 times (once per leaf); loss finite, params moved.
5. check   -- one sample through the UNet with the kernels and with the plain
              attention path: the outputs must agree.
6. int8    -- the same workload with optimizer bitsandbytes.optim.AdamW8bit
              (int8 moments): 3 warm-up and --steps timed steps; per step
              adam8_fused launches 227 times (the int8 leaves),
              adam_bf16_fused 459 times (the fp32-moment leaves) and each
              splash kernel 10 times; loss finite, params moved.

Output: the build's register/spill report, one line per phase, then (before
the last line) a {"kernels": [...]} JSON line and the card's name and power
limit, and last {"ok": true, "device": {"platform": "gpu", ...}}. A full record
goes to chiprun_out/chip_smoke.json. Without a CUDA card it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from scal_sdt_tpu_torch.conf import Config, default, load_optim_target, merge
from scal_sdt_tpu_torch.models.unet import UNetConfig, init_unet_params, unet_apply
from scal_sdt_tpu_torch.ops import _build, adam8_fused, adam_bf16_fused, attention, splash
from scal_sdt_tpu_torch.training.optim_targets import group_labels, resolve_optim_target
from scal_sdt_tpu_torch.training.optimizers import build_optimizer
from scal_sdt_tpu_torch.training.step import StepSpec, init_train_state, make_train_step

# H100 SXM data-sheet peaks (dense bf16 tensor cores, fp32 on the CUDA
# cores, HBM3), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
MAIN_SHAPES = [(8, 8, 4096, 40), (8, 8, 1024, 80)]
ARB_SHAPE = (1, 8, 1344, 40)
CALLS_PER_STEP = 10      # 5 self-attentions at L=4096 + 5 at L=1024
SD15_LEAVES, SD15_INT8_LEAVES = 686, 227
INT8_SHAPES = [(1280, 23040), (320, 2880)]    # (1280,2560,3,3) and (320,320,3,3) views
ADAM_CASES = [  # (shape, moment dtype, nu SR): AdamW's largest leaf; an int8-path small leaf
    ((1280, 23040), torch.bfloat16, True), ((320,), torch.float32, False)]
# fp32 operations per element (dequantize 2, moments 7, step 5, requantize
# 2 x 6; fused Adam: moments 7, step 5) against the CUDA-core fp32 peak
ADAM8_OPS, ADAM_OPS = 26, 12
B1, B2, EPS = 0.9, 0.999, 1e-8
PAYLOAD_FLIPS = 1e-3     # int8 payloads: at most 1 apart in under this share
OPT_TOL = 1e-6           # optimizer step, scales: relative to the tensor's largest
FWD_TOL, GRAD_TOL = 5e-3, 1.5e-2
CHECK_TOL = 5e-2         # UNet output, kernel path vs plain path, relative
OUT_DIR = Path("chiprun_out")

# name -> (port source, the JAX package's entry to the TPU kernel, the Pallas
# kernel it reaches inside jax/experimental/pallas/ops/tpu/splash_attention/)
KERNELS = {
    "splash_fwd": ("scal_sdt_tpu_torch/ops/csrc/splash_fwd.cu", "scal_sdt_tpu/ops/splash.py:88",
                   "splash_attention_kernel.py:1137"),
    "splash_dq": ("scal_sdt_tpu_torch/ops/csrc/splash_bwd.cu", "scal_sdt_tpu/ops/splash.py:88",
                  "splash_attention_kernel.py:1635"),
    "splash_dkv": ("scal_sdt_tpu_torch/ops/csrc/splash_bwd.cu", "scal_sdt_tpu/ops/splash.py:88",
                   "splash_attention_kernel.py:2196"),
    "adam8_fused": ("scal_sdt_tpu_torch/ops/csrc/adam8_fused.cu",
                    "scal_sdt_tpu/ops/adam8_fused.py:92", "scal_sdt_tpu/ops/adam8_fused.py:127"),
    "adam_bf16_fused": ("scal_sdt_tpu_torch/ops/csrc/adam_bf16_fused.cu",
                        "lab/micro_bf16_update.py:62", "lab/micro_bf16_update.py:86"),
}
SPLASH = ("splash_fwd", "splash_dq", "splash_dkv")
COUNTERS = (splash, adam8_fused, adam_bf16_fused)


def reset_launches() -> None:
    for mod in COUNTERS:
        mod.reset_launches()


def read_launches() -> dict[str, int]:
    return {k: v for mod in COUNTERS for k, v in mod.launches.items()}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return max_abs(a, b) / float(b.detach().float().abs().max())


def bounds_ms(b: int, h: int, lq: int, lk: int, d: int) -> dict[str, tuple[float, str]]:
    """Least time per kernel: max(bytes / HBM rate, flops / bf16 peak), with
    each input read once and each output written once. Flops count the
    matrix products each kernel must do: fwd q k^T and P v; dq also
    recomputes S and forms dP and dS k; dkv S^T, dP^T, P^T dO, dS^T q."""
    bh, e = b * h, 2  # bf16 bytes
    tq, tk, row = bh * lq * d * e, bh * lk * d * e, bh * lq * 4  # q-like, k-like, fp32 row
    work = {
        "splash_fwd": (4 * bh * lq * lk * d, tq + 2 * tk + tq + row),          # q k v -> o lse
        "splash_dq": (6 * bh * lq * lk * d, 3 * tq + 2 * tk + row + row + tq),  # q o dO k v lse -> delta dq
        "splash_dkv": (8 * bh * lq * lk * d, 2 * tq + 2 * tk + 2 * row + 2 * tk),  # q dO k v lse delta -> dk dv
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES_PER_S * 1e3
        out[name] = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return out


def head_views(shape, gen: torch.Generator) -> torch.Tensor:
    """A (B, H, L, D) bf16 head-split view of a (B, L, H*D) tensor, the layout
    ops/attention.py hands the kernels."""
    b, h, l, d = shape
    x = torch.randn(b, l, h * d, generator=gen, device="cuda").to(torch.bfloat16)
    return x.view(b, l, h, d).transpose(1, 2)


def kernel_phase(shape, gen: torch.Generator) -> dict:
    b, h, l, d = shape
    scale = d ** -0.5
    q, k, v, do = (head_views(shape, gen) for _ in range(4))
    qs = splash._prescale(q, scale)

    o, lse = splash.splash_fwd(qs, k, v)
    o_ref, lse_ref = splash.splash_fwd_reference(qs, k, v)
    dq, delta = splash.splash_dq(qs, k, v, o, do, lse)
    dq_ref, delta_ref = splash.splash_dq_reference(qs, k, v, o, do, lse)
    dk, dv = splash.splash_dkv(qs, k, v, do, lse, delta)
    dk_ref, dv_ref = splash.splash_dkv_reference(qs, k, v, do, lse, delta)
    torch.cuda.synchronize()
    res = {"shape": list(shape),
           "err": {"splash_fwd": max_abs(o, o_ref), "lse": max_abs(lse, lse_ref),
                   "delta": max_abs(delta, delta_ref),
                   "splash_dq": max_abs(dq, dq_ref), "splash_dq_rel": rel_err(dq, dq_ref),
                   "splash_dkv": max(max_abs(dk, dk_ref), max_abs(dv, dv_ref)),
                   "splash_dkv_rel": max(rel_err(dk, dk_ref), rel_err(dv, dv_ref))}}
    del o_ref, lse_ref, dq_ref, delta_ref, dk_ref, dv_ref
    e = res["err"]
    check(e["splash_fwd"] <= FWD_TOL, f"splash_fwd disagrees at {shape}: {e['splash_fwd']}")
    check(e["splash_dq_rel"] <= GRAD_TOL, f"splash_dq disagrees at {shape}: {e['splash_dq_rel']}")
    check(e["splash_dkv_rel"] <= GRAD_TOL,
          f"splash_dkv disagrees at {shape}: {e['splash_dkv_rel']}")

    # The autograd Function end to end against autograd of the plain version.
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = splash.splash_attention(*leaves, scale)
    want = splash.splash_attention_reference(*refs, scale)
    out.backward(do)
    want.backward(do)
    res["autograd_err"] = {"out": max_abs(out, want),
                           **{f"d{n}_rel": rel_err(a.grad, r.grad)
                              for n, a, r in zip("qkv", leaves, refs)}}
    del out, want, leaves, refs
    check(res["autograd_err"]["out"] <= FWD_TOL, f"splash_attention forward at {shape}")
    check(all(res["autograd_err"][f"d{n}_rel"] <= GRAD_TOL for n in "qkv"),
          f"splash_attention gradients at {shape}: {res['autograd_err']}")

    res["ms"] = {
        "splash_fwd": time_ms(lambda: splash.splash_fwd(qs, k, v)),
        "splash_dq": time_ms(lambda: splash.splash_dq(qs, k, v, o, do, lse)),
        "splash_dkv": time_ms(lambda: splash.splash_dkv(qs, k, v, do, lse, delta)),
    }
    res["plain_ms"] = {
        "splash_fwd": time_ms(lambda: splash.splash_fwd_reference(qs, k, v), iters=3),
        "splash_dq": time_ms(lambda: splash.splash_dq_reference(qs, k, v, o, do, lse),
                             iters=3),
        "splash_dkv": time_ms(lambda: splash.splash_dkv_reference(qs, k, v, do, lse, delta),
                              iters=3),
    }
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    res["sdpa_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    res["sdpa_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True))
    del sdpa_out
    res["bound"] = {n: list(v) for n, v in bounds_ms(b, h, l, l, d).items()}
    del q, k, v, do, qs, o, lse, dq, delta, dk, dv
    torch.cuda.empty_cache()
    return res


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time in ms, and what sets it: bytes over the HBM rate, or fp32
    operations over the CUDA-core peak."""
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def adam8_case(shape, gen: torch.Generator) -> dict:
    """adam8_fused against its plain version on the second step of a state
    the plain version quantized on the first."""
    lead, minor = shape
    nb = -(-minor // adam8_fused.BLOCK)
    grad = lambda: (torch.randn(shape, generator=gen, device="cuda") * 1e-3).bfloat16()
    state = [torch.zeros(lead, nb * adam8_fused.BLOCK, dtype=torch.int8, device="cuda"),
             torch.zeros(lead, nb, device="cuda")]
    state += [t.clone() for t in state]
    hp = dict(b1=B1, b2=B2, eps=EPS)
    inv = lambda t: tuple(1.0 / (1.0 - b ** t) for b in (B1, B2))
    adam8_fused.adam8_fused_update_reference(grad(), *state, *inv(1), **hp)
    g = grad()
    # both sides update their own copy of the state in place
    got = adam8_fused.adam8_fused_update(g, *(t.clone() for t in state), *inv(2), **hp)
    want = adam8_fused.adam8_fused_update_reference(g, *(t.clone() for t in state), *inv(2),
                                                    **hp)
    torch.cuda.synchronize()
    err = {"out": max_abs(got[0], want[0]), "out_rel": rel_err(got[0], want[0])}
    for i, name in ((1, "mu_q"), (3, "nu_q")):
        d = (got[i].int() - want[i].int()).abs()
        err[name + "_max"] = int(d.max())
        err[name + "_share"] = float((d > 0).float().mean())
        check(err[name + "_max"] <= 1 and err[name + "_share"] < PAYLOAD_FLIPS,
              f"adam8_fused {name} at {shape}: {err}")
        check(not got[i][:, minor:].any(), f"adam8_fused {name} padded tail not zero at {shape}")
    err["scales_rel"] = max(rel_err(got[2], want[2]), rel_err(got[4], want[4]))
    check(err["out_rel"] <= OPT_TOL and err["scales_rel"] <= OPT_TOL,
          f"adam8_fused disagrees at {shape}: {err}")
    del got, want
    n, nq = lead * minor, lead * nb * adam8_fused.BLOCK
    nbytes = 2 * n * g.element_size() + 2 * 2 * nq + 2 * 2 * lead * nb * 4
    return {"shape": list(shape), "err": err,
            "ms": time_ms(lambda: adam8_fused.adam8_fused_update(g, *state, *inv(2), **hp)),
            "plain_ms": time_ms(lambda: adam8_fused.adam8_fused_update_reference(
                g, *state, *inv(2), **hp), iters=3),
            "bytes": nbytes, "bound": list(bound(nbytes, ADAM8_OPS * nq)), "library_ms": None}


def adam_case(shape, m_dtype: torch.dtype, sr: bool, gen: torch.Generator) -> dict:
    """adam_bf16_fused against its plain version: AdamW's form (divide, fp32
    step, SR nu) for bf16 moments, the int8 path's (reciprocal, step in the
    gradient's dtype) for fp32 moments."""
    g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).bfloat16()
    mu = (torch.randn(shape, generator=gen, device="cuda") * 1e-4).to(m_dtype)
    nu = (torch.rand(shape, generator=gen, device="cuda") * 1e-7).to(m_dtype)
    t = 3
    bc = tuple(1.0 - b ** t for b in (B1, B2))
    kw = dict(b1=B1, b2=B2, eps=EPS, out_dtype=torch.float32 if sr else g.dtype,
              recip_bc=not sr, **({"sr_step": t, "sr_salt": 0x5EED} if sr else {}))
    # both sides update their own copy of the moments in place
    got = adam_bf16_fused.adam_bf16_fused_update(g, mu.clone(), nu.clone(), bc, **kw)
    want = adam_bf16_fused.adam_bf16_fused_update_reference(g, mu.clone(), nu.clone(), bc, **kw)
    torch.cuda.synchronize()
    err = {"out": max_abs(got[0], want[0]), "out_rel": rel_err(got[0], want[0]),
           "mu_equal": torch.equal(got[1], want[1]), "nu_equal": torch.equal(got[2], want[2])}
    check(err["mu_equal"] and err["nu_equal"] and err["out_rel"] <= OPT_TOL,
          f"adam_bf16_fused disagrees at {shape} {m_dtype}: {err}")
    del got, want
    n = g.numel()
    out_size = torch.empty((), dtype=kw["out_dtype"]).element_size()
    nbytes = n * (g.element_size() + 4 * mu.element_size() + out_size)
    res = {"shape": list(shape), "moments": str(m_dtype), "sr": sr, "err": err,
           "ms": time_ms(lambda: adam_bf16_fused.adam_bf16_fused_update(g, mu, nu, bc, **kw)),
           "plain_ms": time_ms(lambda: adam_bf16_fused.adam_bf16_fused_update_reference(
               g, mu, nu, bc, **kw), iters=3),
           "bytes": nbytes, "bound": list(bound(nbytes, ADAM_OPS * n)), "library_ms": None}
    # nearest library call, not the same function: torch's fused AdamW over
    # bf16 param, gradient and moments of the same leaf
    p, m2, v2 = g.clone(), mu.bfloat16(), nu.bfloat16().abs()
    steps = [torch.tensor(float(t), device="cuda")]
    res["library_ms"] = time_ms(lambda: torch._fused_adamw_(
        [p], [g], [m2], [v2], [], steps, lr=1e-6, beta1=B1, beta2=B2, weight_decay=1e-2,
        eps=EPS, amsgrad=False, maximize=False))
    res["library"] = "torch._fused_adamw_ (bf16 moments; nearest call, not the same function)"
    return res


def optim_phase(gen: torch.Generator) -> dict:
    return {"adam8_fused": [adam8_case(s, gen) for s in INT8_SHAPES],
            "adam_bf16_fused": [adam_case(s, dt, sr, gen) for s, dt, sr in ADAM_CASES]}


def setup_train(seed: int, optimizer: str = "adamw"):
    """The bench.py default workload on the port: SD1.5 at full width, 512^2
    (64^2 latents), batch 8, cached random latents/conds, bf16 masters, bf16
    moments (int8 with ``optimizer="bitsandbytes.optim.AdamW8bit"``), EMA off,
    no remat. Returns a dict with the train state, the step function and the
    pieces it closes over (spec, tx), the batch and the UNet config."""
    batch_size, latent = 8, 64
    config = merge(default(), Config({
        "batch_size": batch_size,
        "gradient_checkpointing": False,
        "trainer": {"precision": "bf16"},
        "ema": {"enabled": False},
        "optimizer": {"name": optimizer, "moment_dtype": "bf16", "master_dtype": "bf16",
                      "params": {"lr": 2e-6, "beta1": 0.9, "beta2": 0.999,
                                 "weight_decay": 1e-2, "eps": 1e-8},
                      "lr_scale": {"enabled": False}},
    }))
    unet_config = UNetConfig.sd15()
    params = init_unet_params(unet_config, seed=seed, device="cuda")
    resolutions = resolve_optim_target(load_optim_target("full_unet"), params.keys(), [])
    labels = group_labels(resolutions)
    overrides = {f"g{i}": g.optimizer for i, g in enumerate(resolutions["unet"].groups)}
    trainable = {f"unet.{k}": v.to(torch.bfloat16) for k, v in params.items()}
    del params
    tx, lr_fn = build_optimizer(config, labels, overrides, steps_per_epoch=1000, num_processes=1)
    spec = StepSpec.from_config(config, unet_config)
    state = init_train_state(trainable, tx, seed=seed)
    step_fn = make_train_step(spec, tx, lr_fn)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch = {"latents": torch.randn(batch_size, 4, latent, latent, generator=gen, device="cuda"),
             "conds": torch.randn(batch_size, 77, unet_config.cross_attention_dim,
                                  generator=gen, device="cuda")}
    return {"state": state, "step_fn": step_fn, "spec": spec, "tx": tx, "batch": batch,
            "unet_config": unet_config}


def train_phase(seed: int, steps: int, optimizer: str, per_step: dict[str, int],
                warmup: int = 3) -> dict:
    """Warm-up, then ``steps`` timed steps; ``per_step`` gives the launches
    per step each counted kernel must make in the timed steps."""
    setup = setup_train(seed, optimizer)
    state, step_fn, batch, unet_config = (setup[k] for k in ("state", "step_fn", "batch",
                                                               "unet_config"))
    del setup
    probe = [k for k in sorted(state.trainable) if "attn1.to_q" in k][:3] + ["unet.conv_in.weight"]
    before = {k: state.trainable[k].clone() for k in probe}

    t0 = time.perf_counter()
    for _ in range(warmup):
        state, metrics = step_fn(state, {}, batch)
        check(math.isfinite(metrics["train_loss"].item()), "non-finite loss in warm-up")
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, metrics = step_fn(state, {}, batch)
        losses.append(metrics["train_loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()

    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"{name} launched {launches[name]} times in {steps} steps, expected {n} per step")
    moved = [k for k in probe if not torch.equal(before[k], state.trainable[k])]
    check(len(moved) == len(probe), f"parameters did not change: {set(probe) - set(moved)}")
    return {"steps": steps, "warmup_s": warm_s, "timed_s": dt, "steps_per_s": steps / dt,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "losses": losses, "launches": launches, "state": state, "batch": batch,
            "unet_config": unet_config}


@torch.no_grad()
def check_phase(train: dict) -> dict:
    """One sample through the UNet with the kernels, then with the plain
    attention path (the kernel gate closed), on the trained bf16 params."""
    state, batch, cfg = train["state"], train["batch"], train["unet_config"]
    params = {k[len("unet."):]: v for k, v in state.trainable.items()}
    x, ctx = batch["latents"][:1].bfloat16(), batch["conds"][:1].bfloat16()
    t = torch.tensor([500], device="cuda")
    with_kernels = unet_apply(params, x, t, ctx, cfg)
    gate = attention.KERNEL_MIN_LEN
    attention.KERNEL_MIN_LEN = 1 << 30
    try:
        plain = unet_apply(params, x, t, ctx, cfg)
    finally:
        attention.KERNEL_MIN_LEN = gate
    check(with_kernels.shape == (1, 4, 64, 64), f"output shape {tuple(with_kernels.shape)}")
    check(bool(torch.isfinite(with_kernels).all()), "non-finite UNet output")
    err = rel_err(with_kernels, plain)
    check(err <= CHECK_TOL, f"UNet output, kernel path vs plain path: {err}")
    return {"unet_rel_err": err}


def optim_entry(name: str, source: str, replaces: str, pallas_kernel: str,
                record: dict) -> dict:
    """The {"kernels": [...]} entry of an optimizer kernel: numbers at the
    largest SD1.5 leaf; launches from the phase whose main path it serves
    (adam8_fused: the int8 phase; adam_bf16_fused: the main train phase)."""
    cases = record["optim"][name]
    main = cases[0]
    phase = "train_int8" if name == "adam8_fused" else "train"
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "pallas_kernel": pallas_kernel,
            "launches": record[phase]["launches"][name],
            "launches_by_phase": {p: record[p]["launches"][name] for p in ("train", "train_int8")},
            "max_abs_err": max(r["err"]["out"] for r in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound"][0],
            "bound_by": main["bound"][1], "library_ms": main["library_ms"],
            "at": main["shape"],
            "by_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound", "library_ms")}
                         for r in cases]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this smoke test runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} ({smi})")
    record: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}

    t0 = time.perf_counter()
    _build.load_library()
    record["build_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "kernels_build.log").write_text(_build.build_log)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(line.strip())
    log(f"build: {record['build_s']:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    record["kernels"] = [kernel_phase(s, gen) for s in MAIN_SHAPES]
    record["kernels_arb"] = kernel_phase(ARB_SHAPE, gen)
    for r in record["kernels"] + [record["kernels_arb"]]:
        log(f"kernels {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")

    record["optim"] = optim_phase(gen)
    for name, cases in record["optim"].items():
        for r in cases:
            log(f"optim {name} {r['shape']}: {json.dumps({k: r[k] for k in r if k != 'shape'})}")
    torch.cuda.empty_cache()

    splash_per_step = {name: CALLS_PER_STEP for name in SPLASH}
    train = train_phase(args.seed, args.steps, "adamw",
                        {**splash_per_step, "adam_bf16_fused": SD15_LEAVES, "adam8_fused": 0})
    log(f"train: {train['steps_per_s']:.4f} steps/s, peak {train['peak_mem_gib']:.2f} GiB, "
        f"losses {train['losses']}, launches {train['launches']}")
    record["check"] = check_phase(train)
    log(f"check: {record['check']}")
    record["train"] = {k: v for k, v in train.items()
                       if k not in ("state", "batch", "unet_config")}
    del train
    torch.cuda.empty_cache()

    int8 = train_phase(args.seed, args.steps, "bitsandbytes.optim.AdamW8bit",
                       {**splash_per_step, "adam8_fused": SD15_INT8_LEAVES,
                        "adam_bf16_fused": SD15_LEAVES - SD15_INT8_LEAVES})
    log(f"int8: {int8['steps_per_s']:.4f} steps/s, peak {int8['peak_mem_gib']:.2f} GiB, "
        f"losses {int8['losses']}, launches {int8['launches']}")
    record["train_int8"] = {k: v for k, v in int8.items()
                            if k not in ("state", "batch", "unet_config")}
    del int8

    main_shape = record["kernels"][0]
    kernels = []
    for name, (source, replaces, pallas_kernel) in KERNELS.items():
        if name not in SPLASH:
            kernels.append(optim_entry(name, source, replaces, pallas_kernel, record))
            continue
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "pallas_kernel": pallas_kernel,
            "launches": record["train"]["launches"][name],
            "max_abs_err": max(r["err"][name] for r in record["kernels"] + [record["kernels_arb"]]),
            "ms": main_shape["ms"][name], "plain_ms": main_shape["plain_ms"][name],
            "bound_ms": main_shape["bound"][name][0],
            "bound_by": main_shape["bound"][name][1],
            "library_ms": main_shape["sdpa_fwd_ms"] if name == "splash_fwd" else None,
            "at": main_shape["shape"],
            "by_shape": [{"shape": r["shape"], "ms": r["ms"][name],
                          "plain_ms": r["plain_ms"][name], "bound_ms": r["bound"][name][0],
                          "sdpa_fwd_ms": r["sdpa_fwd_ms"], "sdpa_bwd_ms": r["sdpa_bwd_ms"]}
                         for r in record["kernels"] + [record["kernels_arb"]]],
        })
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
