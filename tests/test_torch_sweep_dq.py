"""The CPU half of scripts/sweep_dq_shapes.py: reading the dq instances'
registers and spills from nvcc's ptxas report, and writing a variant's
``DqShape`` specializations into a copy of the kernel sources. The builds
and timings run on a card only; ``main`` is not called."""

import pytest

from scripts import sweep_dq_shapes as sweep

# nvcc -Xptxas -v output for one dq instance, one dkv instance and the
# dq instance of another head dim (names as nvcc mangles them).
PTXAS_LOG = """== splash_bwd.cu
ptxas info    : Compiling entry function '_ZN4ssdt16splash_dq_kernelILi48EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt16splash_dq_kernelILi48EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4ssdt17splash_dkv_kernelILi48EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt17splash_dkv_kernelILi48EEEvNS_4ArgsE
    8 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 165 registers, used 1 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4ssdt16splash_dq_kernelILi80EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt16splash_dq_kernelILi80EEEvNS_4ArgsE
    88 bytes stack frame, 44 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 392 bytes cmem[0]
"""


def test_ptxas_report_of_the_dq_instances():
    """Only the dq instances are read; spill counts stores and loads."""
    assert sweep.ptxas_dq(PTXAS_LOG) == {48: {"spill": 0, "registers": 128},
                                         80: {"spill": 88, "registers": 128}}


@pytest.mark.parametrize("shapes", [{48: "8,64,3,2,16", 80: "4,32,3,3,32"}, None])
def test_variant_specializes_dq_shape(shapes, tmp_path, monkeypatch):
    """A variant is a copy of ops/csrc whose splash_bwd.cu gains one explicit
    DqShape specialization per head dim right after the primary template;
    without shapes the copy is the tree's own."""
    monkeypatch.setattr(sweep, "SWEEP_DIR", tmp_path)
    src = sweep.make_variant("v", shapes)
    assert sorted(p.name for p in src.iterdir()) == sorted(
        p.name for p in sweep._build.CSRC.iterdir())
    text = (src / "splash_bwd.cu").read_text()
    tree = (sweep._build.CSRC / "splash_bwd.cu").read_text()
    if shapes is None:
        assert text == tree
        return
    # the specializations sit between the primary template and dq_smem_bytes
    start = text.index("template <>\nstruct DqShape<")
    end = text.index("template <int DP>\nconstexpr size_t dq_smem_bytes") - 1
    assert text[:start - 1] + text[end:] == tree
    for dp, shape in shapes.items():
        warps, keys, stages, min_blocks, step = shape.split(",")
        spec = text[text.index(f"struct DqShape<{dp}> {{"):]
        spec = spec[:spec.index("};")]
        assert f"warps = {warps}, keys = {keys}, stages = {stages};" in spec
        assert f"min_blocks = {min_blocks}, step = {step};" in spec
