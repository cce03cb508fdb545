"""Multi-head attention for the UNet (port of ``scal_sdt_tpu/ops/attention.py``).

Two paths, chosen by ``_dispatch`` with the JAX package's gate:

* ``_attention_math``: the plain einsum chain of ``_attention_xla`` (fp32
  scores and softmax, probabilities back in the input dtype). Cross-attention
  (Lk = 77), the low-resolution levels, causal masks and every CPU tensor
  take it.
* the splash kernels (``ops/splash.py``) for long non-causal self-attention
  on CUDA: both lengths >= 1024 and D <= 256, as on the TPU. The kernels
  bound ragged tails themselves, so the ARB lengths that no block divides
  (the TPU version's padded branch) take them too.

The multi-device ``shard_map`` wrapper of the JAX version has no counterpart
yet: multi-GPU is a later slice.
"""

from __future__ import annotations

import torch

from .splash import splash_attention

# Both lengths at least this long take the kernels (the TPU gate's default).
KERNEL_MIN_LEN = 1024
# Head dims above this stay on the math path (the frozen VAE's D=512).
KERNEL_MAX_HEAD_DIM = 256


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


def _dispatch(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, scale: float,
              causal: bool) -> torch.Tensor:
    use_kernel = (not causal
                  and qh.shape[2] >= KERNEL_MIN_LEN
                  and kh.shape[2] >= KERNEL_MIN_LEN
                  and qh.shape[3] <= KERNEL_MAX_HEAD_DIM
                  and qh.is_cuda)
    if use_kernel:
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
