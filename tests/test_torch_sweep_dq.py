"""The CPU half of scripts/sweep_dq_shapes.py: reading the forward, dq and
dkv instances' registers and spills from nvcc's ptxas report, parsing a
variant, and writing its ``FwdShape`` / ``DqShape`` / ``DkvShape``
specializations into a copy of the kernel sources. The builds and timings
run on a card only; ``main`` is not called."""

import pytest

from scripts import sweep_dq_shapes as sweep

# nvcc -Xptxas -v output for the forward's two instances of one head dim
# (3 and 2 consumers), one dq instance, one dkv instance and the dq instance
# of another head dim (names as nvcc mangles them).
PTXAS_LOG = """== splash_fwd.cu
ptxas info    : Compiling entry function '_ZN4ssdt17splash_fwd_kernelILi48ELi3EEEv14CUtensorMap_stS1_S1_S1_NS_7FwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt17splash_fwd_kernelILi48ELi3EEEv14CUtensorMap_stS1_S1_S1_NS_7FwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN4ssdt17splash_fwd_kernelILi48ELi2EEEv14CUtensorMap_stS1_S1_S1_NS_7FwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt17splash_fwd_kernelILi48ELi2EEEv14CUtensorMap_stS1_S1_S1_NS_7FwdArgsE
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
== splash_bwd.cu
ptxas info    : Compiling entry function '_ZN4ssdt16splash_dq_kernelILi48EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt16splash_dq_kernelILi48EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4ssdt17splash_dkv_kernelILi48EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt17splash_dkv_kernelILi48EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE
    8 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4ssdt16splash_dq_kernelILi80EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4ssdt16splash_dq_kernelILi80EEEv14CUtensorMap_stS1_S1_S1_NS_7BwdArgsE
    88 bytes stack frame, 44 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_report_of_the_dq_instances():
    """Only the dq instances are read; spill counts stores and loads."""
    assert sweep.ptxas(PTXAS_LOG, "dq") == {48: {"spill": 0, "registers": 168},
                                            80: {"spill": 88, "registers": 168}}


def test_ptxas_report_of_the_forward_instances():
    """Only the forward's instances are read, one per head dim and consumer
    count."""
    assert sweep.ptxas(PTXAS_LOG, "fwd") == {"48/3": {"spill": 0, "registers": 128},
                                             "48/2": {"spill": 20, "registers": 168}}


def test_ptxas_report_of_the_dkv_instances():
    """Only the dkv instances are read."""
    assert sweep.ptxas(PTXAS_LOG, "dkv") == {48: {"spill": 64, "registers": 168}}


def test_a_variant_spec_names_kernel_head_dim_and_fields():
    assert sweep.parse_spec("dq48=3,64,3 dkv160=1,32,2,0 fwd64=4,64,4") == {
        ("dq", 48): "3,64,3", ("dkv", 160): "1,32,2,0", ("fwd", 64): "4,64,4"}
    for bad in ("dq48=2,64", "dq48=2,64,3,1", "dkv48=2,64,3", "dkv48=2,64,3,1,1",
                "fwd48=2,64", "fwd48=2,64,3,1", "bwd48=2,64,3"):
        with pytest.raises(ValueError):
            sweep.parse_spec(bad)


@pytest.mark.parametrize("items", [{("dq", 48): "2,64,3", ("dkv", 80): "1,64,2,0",
                                    ("dkv", 48): "2,64,2,1", ("fwd", 64): "3,128,4",
                                    ("fwd", 48): "2,64,3"},
                                   {("fwd", 160): "1,64,2"}, None])
def test_variant_specializes_dq_shape(items, tmp_path, monkeypatch):
    """A variant is a copy of ops/csrc whose splash_fwd.cu gains, per item,
    FwdConsumers specialized to the item's consumers alone and FwdShape
    specialized to its fields, and whose splash_bwd.cu gains one DqShape or
    DkvShape specialization per item, right after the shape's primary
    template; without items the copy is the tree's own."""
    monkeypatch.setattr(sweep, "SWEEP_DIR", tmp_path)
    src = sweep.make_variant("v", items)
    assert sorted(p.name for p in src.iterdir()) == sorted(
        p.name for p in sweep._build.CSRC.iterdir())
    for p in src.iterdir():
        text = p.read_text()
        tree = (sweep._build.CSRC / p.name).read_text()
        # taking the specializations out leaves the tree's file
        stripped = text
        for kernel, (struct, source, _, _) in sweep.STRUCTS.items():
            if source != p.name or not any(k == kernel for k, _ in items or {}):
                continue
            first = "FwdConsumers" if kernel == "fwd" else struct
            start = stripped.index(f"template <>\nstruct {first}<")
            end = stripped.rindex(f"struct {struct}<")
            end = stripped.index("};\n", end) + 3
            stripped = stripped[:start - 1] + stripped[end:]
        assert stripped == tree
    for (kernel, dp), fields in (items or {}).items():
        struct, source, tile, flags = sweep.STRUCTS[kernel]
        text = (src / source).read_text()
        consumers, rows, stages, *values = fields.split(",")
        if kernel == "fwd":
            assert (f"struct FwdConsumers<{dp}> {{\n  static constexpr int wide = {consumers}, "
                    f"narrow = {consumers};\n}};") in text
            dp = f"{dp}, {consumers}"
        spec = text[text.index(f"struct {struct}<{dp}> {{"):]
        spec = spec[:spec.index("};")]
        assert f"consumers = {consumers}, {tile} = {rows}, stages = {stages};" in spec
        if flags:
            assert "static constexpr bool " + ", ".join(
                f"{f} = {'true' if v == '1' else 'false'}" for f, v in zip(flags, values)) in spec
        else:
            assert "bool" not in spec
