"""The plain reference agrees with the port on the CPU at tiny
configurations, both in float32 (the tiny traffic mixes run the port's
float32 path), through the harness's own comparison; and the MMDiT's
FLOP count from its shapes matches ``FlopCounterMode`` on the meta device."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.families import mmdit as mmdit_family
from benchmark.harness import spec as spec_mod
from benchmark.harness.runner import run_cell
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference.numerics import Numerics
from benchmark.tests import tiny

# float32 on both sides: the gaps are round-off of another summation order
AGREE = {"loss": 1e-5, "grad": 1e-5, "update": 1e-4, "update_median": 1e-4,
         "image_gap": 1e-3, "image_worst": 2e-3}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_reference_agrees_with_the_port(root, cell):
    result = run_cell(spec_mod.resolve(cell, root), 2 ** 31 + 3, 0.05, False, "cpu")
    for name, value in result["readings"].items():
        if name != "quiet_leaves":   # a count: the leaves the loss does not reach
            assert value <= AGREE[name], (name, value)
    assert result["correct"]


def _meta_count(fn, *args) -> float:
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


@pytest.mark.parametrize("which", ["sd3-medium", "tiny"])
def test_mmdit_flops_from_shapes(which):
    from scal_sdt_tpu_torch.models.mmdit import MMDiTConfig, mmdit_apply, mmdit_param_shapes
    from scal_sdt_tpu_torch.ops import attention

    if which == "tiny":
        cfg, res, ctx = tiny.MMDIT, 16, 7
        port_cfg = MMDiTConfig.tiny()
    else:
        cfg = spec_mod.resolve("sd3-ft-1024-b6-cached").config
        res, ctx = 1024, 154
        port_cfg = MMDiTConfig.sd3_medium()
    meta = torch.device("meta")
    c, h, w = mmdit_family.latent_shape(cfg, res)
    x = torch.empty(1, c, h, w, device=meta)
    t = torch.zeros(1, device=meta)
    context = torch.empty(1, ctx, cfg["joint_attention_dim"], device=meta)
    pooled = torch.empty(1, cfg["pooled_projection_dim"], device=meta)
    ref = {k: torch.empty(s, device=meta) for k, s in ref_mmdit.mmdit_shapes(cfg).items()}
    port = {k: torch.empty(s, device=meta) for k, s in mmdit_param_shapes(port_cfg).items()}
    shapes_count = mmdit_family.forward_flops(cfg, res, ctx)
    assert _meta_count(ref_mmdit.mmdit_forward, ref, x, t, context, pooled, cfg,
                       Numerics()) == shapes_count
    prev, attention.FORCE_MATH = attention.FORCE_MATH, True
    try:
        assert _meta_count(mmdit_apply, port, x, t, context, pooled, port_cfg) == shapes_count
    finally:
        attention.FORCE_MATH = prev
