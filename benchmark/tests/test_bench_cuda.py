"""On the card: the control of each cell, at the cell's configuration and a
smaller batch, is not correct by the cell's own limits. Skips without a
card.

    python3 -m pytest benchmark/tests/test_bench_cuda.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import spec as spec_mod
from benchmark.harness.runner import check_numbers, make_work
from benchmark.reference.numerics import Numerics, no_tf32

pytestmark = pytest.mark.cuda
SPEC = json.loads((spec_mod.ROOT / "BENCHMARK.json").read_text())
SMALLER = {"train": {"batch": 2}, "sample": {"batch": 2}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with no_tf32():
        yield "cuda"
    torch.cuda.empty_cache()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"] if w["chips"] == 1])
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_fails_the_cells_limits(cuda, cell, seed):
    c = spec_mod.resolve(cell)
    c.traffic.update(SMALLER[c.traffic["kind"]])
    work, _ = make_work(c, seed, cuda)
    work.control_inputs()
    numbers = work.numbers(work.reference_readings(Numerics("fp8")),
                           work.reference_readings(Numerics("fp32")))
    assert not all(x["ok"] for x in check_numbers(numbers, c.limits).values()), numbers
