"""What ``correct`` has to catch, at tiny sizes on the CPU: the control (the
reference in float8 operands in the program's place) and each fault a cell
can have, planted under a whole run, read past the tiny cells' limits."""

from __future__ import annotations

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.harness.runner import check_numbers, make_work, run_cell
from benchmark.reference.numerics import Numerics, no_tf32
from benchmark.tests import tiny

FAULTS = [("tiny-unet-train", "unchanged"), ("tiny-unet-train", "half_batch"),
          ("tiny-mmdit-train", "unchanged"), ("tiny-mmdit-train", "half_batch"),
          ("tiny-unet-sample", "altered")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(root, cell, fault):
    result = run_cell(spec_mod.resolve(cell, root), 11, 0.05, False, "cpu", fault=fault)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("cell", list(tiny.CELLS))
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 9])
def test_the_control_is_not_correct(root, cell, seed):
    c = spec_mod.resolve(cell, root)
    work, _ = make_work(c, seed, "cpu")
    work.control_inputs()
    with no_tf32():
        numbers = work.numbers(work.reference_readings(Numerics("fp8")),
                               work.reference_readings(Numerics("fp32")))
    assert not all(x["ok"] for x in check_numbers(numbers, c.limits).values()), numbers
