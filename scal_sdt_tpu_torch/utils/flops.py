"""Model FLOP counting for MFU (port of ``scal_sdt_tpu/utils/flops.py``).

Counts the matmul and convolution FLOPs of one call of a function by running
it under ``torch.utils.flop_counter.FlopCounterMode`` and keeping only the
matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``) and ``convolution``:
a product contributes ``2·batch·M·N·K``, a convolution
``2·|out|·k_h·k_w·C_in/groups``. This is the usual "model FLOPs" convention
(elementwise, softmax and norms left out), the numerator of
``MFU = model_flops_per_step · steps_per_sec / peak_flops``.

``train_step_flops`` runs the UNet forward on ``device="meta"`` from the
``unet_param_shapes`` templates: no memory, no card, as JAX traces
``ShapeDtypeStruct``s. A train step is ``3 ×`` the forward (the backward is
about twice the forward's matmul FLOPs); remat recompute is not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["count_matmul_conv_flops", "train_step_flops", "GPU_PEAK_FLOPS"]

# Dense bf16 tensor-core peak FLOP/s per card (NVIDIA's data sheets, without
# sparsity, at the part's full power limit), keyed by
# ``torch.cuda.get_device_name()``: the denominators of MFU.
GPU_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,
}

COUNTED_OPS = ("mm", "bmm", "addmm", "baddbmm", "convolution")


def count_matmul_conv_flops(fn, *args, **kwargs) -> float:
    """Matmul + convolution FLOPs of one call of ``fn(*args, **kwargs)``.

    Args may live on ``device="meta"``. Attention must take the plain path
    for its products to be seen as matmuls: set ``ops.attention.FORCE_MATH``
    (the kernel gate refuses meta tensors anyway)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    counts = counter.get_flop_counts().get("Global", {})
    return float(sum(n for op, n in counts.items() if op.__name__ in COUNTED_OPS))


def train_step_flops(unet_config, batch: int, latent_hw: int, context_len: int = 77) -> float:
    """Model FLOPs of one full-fine-tune train step (3 × UNet forward) at the
    given batch and square latent size, with the attention products counted
    as matmuls."""
    from ..models.unet import unet_apply, unet_param_shapes
    from ..ops import attention as attention_ops

    meta = torch.device("meta")
    # dtype does not change the FLOP count; match the fp32 param templates
    params = {k: torch.empty(s, device=meta) for k, s in unet_param_shapes(unet_config).items()}
    x = torch.empty(batch, unet_config.in_channels, latent_hw, latent_hw, device=meta)
    t = torch.empty(batch, dtype=torch.long, device=meta)
    ctx = torch.empty(batch, context_len, unet_config.cross_attention_dim, device=meta)

    prev = attention_ops.FORCE_MATH
    attention_ops.FORCE_MATH = True
    try:
        fwd = count_matmul_conv_flops(unet_apply, params, x, t, ctx, unet_config)
    finally:
        attention_ops.FORCE_MATH = prev
    return 3.0 * fwd
