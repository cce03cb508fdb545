"""How the plain reference computes its products.

The reference runs in float32 with TF32 off, the precision the benchmark
holds the program to. ``Numerics("fp8")`` is the benchmark's control: the
same reference with every operand of a linear layer, a convolution and the
two attention products rounded to float8 e4m3 (a per-tensor scale that maps
the largest magnitude to 448), the step below the bfloat16 the
configurations state. The rounding is applied in the forward pass only; the
backward takes the rounded operands' products as they are (straight
through), in float32.

Attention is the textbook softmax(q k^T * scale) v in blocks of query rows,
each block recomputed in the backward (``torch.utils.checkpoint``), so that
no full (Lq, Lk) score matrix of a long sequence is kept.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0          # the largest finite float8 e4m3fn
BLOCK = 1024             # query rows per attention block
OPERANDS = ("fp32", "fp8")


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 inside: TF32 off for cuBLAS and cuDNN,
    the settings restored after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class Numerics:
    """The reference's products: ``operands`` 'fp32' (the reference) or
    'fp8' (the control); each block of ``BLOCK`` query rows of an attention
    is recomputed in the backward unless ``checkpoint_attention`` is off."""

    def __init__(self, operands: str = "fp32", checkpoint_attention: bool = True):
        if operands not in OPERANDS:
            raise ValueError(f"operands must be one of {OPERANDS}, got {operands!r}")
        self.operands, self.checkpoint_attention = operands, checkpoint_attention

    def within_checkpoint(self) -> "Numerics":
        """The same products for a caller that recomputes its whole block in
        the backward: no second recompute of each attention block."""
        return Numerics(self.operands, checkpoint_attention=False)

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.operands == "fp32":
            return t
        scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (q - t).detach()

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        return F.linear(self.round(x), self.round(w), b)

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
               padding: int = 1) -> torch.Tensor:
        return F.conv2d(self.round(x), self.round(w), b, stride=stride, padding=padding)

    def _attention_rows(self, q, k, v, scale: float, causal_from: int | None):
        s = torch.matmul(self.round(q), self.round(k).transpose(-1, -2)) * scale
        if causal_from is not None:
            rows = torch.arange(q.shape[2], device=q.device)[:, None] + causal_from
            cols = torch.arange(k.shape[2], device=q.device)[None, :]
            s = s.masked_fill(cols > rows, float("-inf"))
        return torch.matmul(self.round(torch.softmax(s, dim=-1)), self.round(v))

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  causal: bool = False) -> torch.Tensor:
        """q (B, H, Lq, D), k and v (B, H, Lk, D) -> (B, H, Lq, D)."""
        out = []
        for start in range(0, q.shape[2], BLOCK):
            qb = q[:, :, start:start + BLOCK]
            args = (qb, k, v, scale, start if causal else None)
            if self.checkpoint_attention and torch.is_grad_enabled() and q.requires_grad:
                out.append(checkpoint(self._attention_rows, *args, use_reentrant=False))
            else:
                out.append(self._attention_rows(*args))
        return torch.cat(out, dim=2)

    def heads_attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, scale: float | None = None,
                        causal: bool = False) -> torch.Tensor:
        """q (B, Lq, C), k and v (B, Lk, C) split into ``heads`` -> (B, Lq, C)."""
        b, lq, c = q.shape
        d = c // heads

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], heads, d).transpose(1, 2)

        out = self.attention(split(q), split(k), split(v),
                             float(d) ** -0.5 if scale is None else scale, causal)
        return out.transpose(1, 2).reshape(b, lq, c)


def group_norm(p: dict, name: str, x: torch.Tensor, groups: int, eps: float = 1e-5):
    return F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"], eps)


def layer_norm(p: dict, name: str, x: torch.Tensor, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def lin(nx: Numerics, p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return nx.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def conv(nx: Numerics, p: dict, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 1) -> torch.Tensor:
    return nx.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride, padding)


def sinusoidal(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
               shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    """diffusers' get_timestep_embedding, float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / (half - shift)
    args = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
