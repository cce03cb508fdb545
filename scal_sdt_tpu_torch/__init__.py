"""PyTorch/CUDA port of SCAL-SDT-TPU for NVIDIA Hopper.

Module names follow ``scal_sdt_tpu`` so each counterpart is easy to find; the
JAX package stays the reference this one is tested against. Parameters are
the same flat ``{diffusers name: tensor}`` dicts in torch layouts; activations
are NCHW. This package imports torch only, never JAX or ``scal_sdt_tpu``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
