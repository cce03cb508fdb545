"""Multi-head attention for the UNet (port of ``scal_sdt_tpu/ops/attention.py``).

Two paths, chosen by ``_dispatch`` with the JAX package's gate:

* ``_attention_math``: the plain einsum chain of ``_attention_xla`` (fp32
  scores and softmax, probabilities back in the input dtype). Cross-attention
  (Lk = 77), the low-resolution levels, causal masks and every CPU tensor
  take it.
* the splash kernels (``ops/splash.py``) for long non-causal self-attention
  on CUDA: both lengths >= 1024, as on the TPU, and a call the kernels take
  (``splash.kernel_accepts``: bf16, D a multiple of 8 and at most 160, B*H
  within the grid). The TPU gate admits D <= 256; here a head dim the
  kernels refuse (161-256, or not a multiple of 8) takes the math path
  instead of raising. The kernels bound ragged tails themselves, so the ARB
  lengths that no block divides (the TPU version's padded branch) take them
  too. CLIP's causal attention and the VAE's single-head D = 512 attention
  take the math path, as they take XLA's on the TPU.

``FORCE_MATH`` closes the gate: every call takes ``_attention_math``. The
trainer sets it from the config's ``xformers: false``, as the JAX trainer sets
``FORCE_XLA`` (``scal_sdt_tpu/ops/attention.py``) to keep calls off the
Pallas kernels.

The JAX version's multi-device ``shard_map`` wrapper (``_dispatch_sharded``)
has no counterpart: under tensor parallelism each rank's call already holds
its own H / tensor heads (``parallel/tensor.py``), and no call is split.
"""

from __future__ import annotations

import torch

from .splash import kernel_accepts, splash_attention

# Both lengths at least this long take the kernels (the TPU gate's default).
KERNEL_MIN_LEN = 1024

# Every call takes the math path when set (the config's `xformers: false`).
FORCE_MATH = False


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, C) -> (B, H, L, D) as a strided view, no copy."""
    b, l, c = x.shape
    return x.reshape(b, l, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _attention_math(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v: (B, H, L, D). fp32 scores * scale (+ mask), fp32 softmax."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _causal_mask(lq: int, lk: int, device: torch.device) -> torch.Tensor:
    keep = torch.ones(lq, lk, dtype=torch.bool, device=device).tril()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(keep, zero, float("-inf"))[None, None]


def use_kernel(q_shape, k_shape, dtype: torch.dtype, causal: bool, is_cuda: bool) -> bool:
    """The gate: (B, H, Lq, D) queries and (B, H, Lk, D) keys of ``dtype``
    go to the splash kernels, or to ``_attention_math``."""
    return (is_cuda and not causal and not FORCE_MATH
            and q_shape[2] >= KERNEL_MIN_LEN and k_shape[2] >= KERNEL_MIN_LEN
            and kernel_accepts(q_shape, dtype))


def _dispatch(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, scale: float,
              causal: bool) -> torch.Tensor:
    if use_kernel(qh.shape, kh.shape, qh.dtype, causal, qh.is_cuda):
        return splash_attention(qh, kh, vh, scale)
    mask = _causal_mask(qh.shape[2], kh.shape[2], qh.device) if causal else None
    return _attention_math(qh, kh, vh, scale, mask)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float | None = None,
                         causal: bool = False) -> torch.Tensor:
    """q: (B, Lq, C); k, v: (B, Lk, C). Returns (B, Lq, C)."""
    head_dim = q.shape[-1] // num_heads
    if scale is None:
        scale = float(head_dim) ** -0.5
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    return _merge_heads(_dispatch(qh, kh, vh, scale, causal)).to(q.dtype)
