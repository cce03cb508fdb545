"""The work counts behind chip_smoke.py's least-time bounds of the splash
kernels, against numbers worked out by hand: tensor-core flops, HBM bytes
(each input read once, each output written once) and exponentials (one per
score), at the main path's long shape, at the ARB shape no block divides
and at SDXL's level-1 shape (head dim 64); and the splash calls per UNet
forward that chip_smoke.py expects (one per transformer block). Only the
counting functions run; ``main`` is not called."""

import pytest

import chip_smoke
from scal_sdt_tpu_torch.models.unet import UNetConfig

# (8, 8, 4096, 40): B*H = 64 heads, L*L = 16,777,216 scores per head.
#   q-like tensor 64*4096*40*2 = 20,971,520 bytes; fp32 row 64*4096*4 = 1,048,576.
# (1, 8, 1344, 40): 8 heads, 1,806,336 scores per head.
#   q-like tensor 8*1344*40*2 = 860,160 bytes; fp32 row 8*1344*4 = 43,008.
EXPECTED = {
    (8, 8, 4096, 40): {
        # flops: 4, 6, 8 x (B*H*L*L*D = 42,949,672,960)
        "splash_fwd": (171_798_691_840, 4 * 20_971_520 + 1_048_576, 1_073_741_824),
        "splash_dq": (257_698_037_760, 6 * 20_971_520 + 2 * 1_048_576, 1_073_741_824),
        "splash_dkv": (343_597_383_680, 6 * 20_971_520 + 2 * 1_048_576, 1_073_741_824),
    },
    (1, 8, 1344, 40): {
        # B*H*L*L*D = 8*1,806,336*40 = 578,027,520
        "splash_fwd": (2_312_110_080, 4 * 860_160 + 43_008, 14_450_688),
        "splash_dq": (3_468_165_120, 6 * 860_160 + 2 * 43_008, 14_450_688),
        "splash_dkv": (4_624_220_160, 6 * 860_160 + 2 * 43_008, 14_450_688),
    },
    # (1, 10, 4096, 64): 10 heads; q-like tensor 10*4096*64*2 = 5,242,880
    # bytes, fp32 row 10*4096*4 = 163,840; B*H*L*L*D = 10,737,418,240
    (1, 10, 4096, 64): {
        "splash_fwd": (42_949_672_960, 4 * 5_242_880 + 163_840, 167_772_160),
        "splash_dq": (64_424_509_440, 6 * 5_242_880 + 2 * 163_840, 167_772_160),
        "splash_dkv": (85_899_345_920, 6 * 5_242_880 + 2 * 163_840, 167_772_160),
    },
}


@pytest.mark.parametrize("shape", sorted(EXPECTED))
def test_splash_work_counts(shape):
    b, h, l, d = shape
    assert chip_smoke.splash_work(b, h, l, l, d) == EXPECTED[shape]


def test_exp_unit_bounds_the_d40_forward():
    """At an H100's 132 SMs and 1980 MHz the D = 40 forward is bound by its
    1.07e9 exponentials (0.2568 ms), above its tensor-core time (0.1737 ms);
    dq and dkv stay bound by the tensor cores."""
    got = chip_smoke.bounds_ms(8, 8, 4096, 4096, 40, sms=132, sm_clock_hz=1.98e9)
    assert got["splash_fwd"][1] == "exp"
    assert got["splash_fwd"][0] == pytest.approx(1_073_741_824 / (132 * 16 * 1.98e9) * 1e3)
    assert got["splash_fwd"][0] == pytest.approx(0.25678, rel=1e-4)
    for name, flops in (("splash_dq", 257_698_037_760), ("splash_dkv", 343_597_383_680)):
        assert got[name][1] == "operations"
        assert got[name][0] == pytest.approx(flops / 989e12 * 1e3)


def test_sdxl_level1_forward_is_bound_by_the_tensor_cores():
    """SDXL's (1, 10, 4096, 64) forward: 42.9 GFLOP over 989 TFLOP/s is
    0.0434 ms, above its exponentials' 0.0397 ms at 132 SMs and 1980 MHz."""
    got = chip_smoke.bounds_ms(1, 10, 4096, 4096, 64, sms=132, sm_clock_hz=1.98e9)
    assert got["splash_fwd"][1] == "operations"
    assert got["splash_fwd"][0] == pytest.approx(0.043428, rel=1e-4)


@pytest.mark.parametrize("config,size,calls", [
    ("sd15", (512, 512), 10),       # 5 transformers of one block at L = 4096, 5 at 1024
    ("sdxl", (1024, 1024), 70),     # level 1: 5 x 2 blocks at 4096; level 2: 6 x 10 at 1024
    ("sdxl", (1408, 1024), 70),     # L = 5632 and 1408
    ("sdxl", (1152, 896), 10),      # level 2's L = 36 * 28 = 1008 takes the math path
])
def test_splash_calls_count_each_transformer_block(config, size, calls):
    w, h = size
    assert chip_smoke.splash_calls((2, h, w, 3), getattr(UNetConfig, config)()) == calls
