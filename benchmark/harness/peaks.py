"""Published peaks of the cards the benchmark runs on, keyed by
``torch.cuda.get_device_name()``: NVIDIA's data sheet for the H100 SXM5
(dense rates, without sparsity, at the full 700 W power limit).

``exp_per_s``: the special-function unit's exponentials, 16 per clock per
SM (sm_90) at the 1,980 MHz boost clock over 132 SMs.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "exp_per_s": 132 * 16 * 1.98e9,
    },
}


def of(device_name: str) -> dict | None:
    return PEAKS.get(device_name)
