"""T5 encoder stack over a flat param dict (port of
``scal_sdt_tpu/models/t5.py``): SD3's third text encoder (text_encoder_3,
T5-XXL v1.1's encoder).

Parameter keys are transformers' state-dict names. The numbers follow
transformers' T5: RMS layer norm in fp32 (eps 1e-6), attention logits NOT
scaled by 1/sqrt(d) (T5 folds that into its initialization), one
relative-position bias shared by every layer and owned by block 0, and a
relu or gated-gelu ("gelu_new", the tanh form) feed-forward.

The attention stays plain PyTorch: it adds the position bias to the scores,
so the JAX package computes it in XLA outside any Pallas kernel, and it is
not sent to the splash kernels. ``t5_encoder_apply`` computes in ``dtype``
(fp32 by default, as the JAX package's SD3 paths call it) whatever the
weights' dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .functional import Params, init_params

T5_EPS = 1e-6
RELATIVE_BIAS_KEY = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    feed_forward_proj: str = "relu"  # 'relu' | 'gated-gelu'

    @property
    def gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    @classmethod
    def t5_xxl(cls) -> "T5Config":
        # google/t5-v1_1-xxl's encoder: SD3's text_encoder_3/config.json
        return cls(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24,
                   num_heads=64, feed_forward_proj="gated-gelu")

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=256, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)

    @classmethod
    def from_json(cls, d: dict) -> "T5Config":
        return cls(
            vocab_size=d.get("vocab_size", 32128),
            d_model=d.get("d_model", 512),
            d_kv=d.get("d_kv", 64),
            d_ff=d.get("d_ff", 2048),
            num_layers=d.get("num_layers", 6),
            num_heads=d.get("num_heads", 8),
            relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
            feed_forward_proj=d.get("feed_forward_proj", "relu"),
        )


def _rms_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.square(xf).mean(dim=-1, keepdim=True) + T5_EPS)
    return (p[f"{name}.weight"].float() * xf).to(x.dtype)


def _proj(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.linear(x, p[f"{name}.weight"].to(x.dtype))


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional bucket ids (transformers
    T5Attention._relative_position_bucket)."""
    num_buckets //= 2
    buckets = torch.where(relative_position > 0, num_buckets, 0)
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    # the log of the small distances is never used; clamp keeps log(0) out
    large = max_exact + (
        torch.log(rel.clamp(min=1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


def _position_bias(p: Params, seq_len: int, config: T5Config, dtype: torch.dtype
                   ) -> torch.Tensor:
    """(1, H, L, L) shared relative-position bias from block 0's table."""
    table = p[RELATIVE_BIAS_KEY]
    pos = torch.arange(seq_len, device=table.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],   # memory - query
                                       config.relative_attention_num_buckets,
                                       config.relative_attention_max_distance)
    return table[buckets].permute(2, 0, 1)[None].to(dtype)


def _self_attention(p: Params, pre: str, x: torch.Tensor, bias: torch.Tensor,
                    config: T5Config) -> torch.Tensor:
    b, l, _ = x.shape
    h, dk = config.num_heads, config.d_kv

    def heads(t):
        return t.reshape(b, l, h, dk).transpose(1, 2)

    q, k, v = (heads(_proj(p, f"{pre}.{n}", x)) for n in ("q", "k", "v"))
    # no 1/sqrt(d_kv) scaling (T5); fp32 scores and softmax
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, l, h * dk)
    return _proj(p, f"{pre}.o", out)


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    """transformers NewGELUActivation (the tanh approximation)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * torch.pow(x, 3.0))))


def _feed_forward(p: Params, pre: str, x: torch.Tensor, config: T5Config) -> torch.Tensor:
    if config.gated:
        h = _gelu_new(_proj(p, f"{pre}.wi_0", x)) * _proj(p, f"{pre}.wi_1", x)
    else:
        h = torch.relu(_proj(p, f"{pre}.wi", x))
    return _proj(p, f"{pre}.wo", h)


def t5_encoder_apply(params: Params, input_ids: torch.Tensor, config: T5Config,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """input_ids (B, L) integer -> the last hidden state (B, L, d_model) in
    ``dtype``."""
    emb_key = "shared.weight" if "shared.weight" in params else "encoder.embed_tokens.weight"
    x = params[emb_key].to(dtype)[input_ids.long()]
    bias = _position_bias(params, input_ids.shape[1], config, dtype)
    for i in range(config.num_layers):
        blk = f"encoder.block.{i}"
        n = _rms_norm(params, f"{blk}.layer.0.layer_norm", x)
        x = x + _self_attention(params, f"{blk}.layer.0.SelfAttention", n, bias, config)
        n = _rms_norm(params, f"{blk}.layer.1.layer_norm", x)
        x = x + _feed_forward(params, f"{blk}.layer.1.DenseReluDense", n, config)
    return _rms_norm(params, "encoder.final_layer_norm", x)


def t5_param_shapes(config: T5Config) -> dict[str, tuple[int, ...]]:
    d, inner = config.d_model, config.num_heads * config.d_kv
    s: dict[str, tuple[int, ...]] = {"shared.weight": (config.vocab_size, d)}
    for i in range(config.num_layers):
        blk = f"encoder.block.{i}"
        att = f"{blk}.layer.0.SelfAttention"
        s[f"{att}.q.weight"] = (inner, d)
        s[f"{att}.k.weight"] = (inner, d)
        s[f"{att}.v.weight"] = (inner, d)
        s[f"{att}.o.weight"] = (d, inner)
        s[f"{blk}.layer.0.layer_norm.weight"] = (d,)
        ff = f"{blk}.layer.1.DenseReluDense"
        if config.gated:
            s[f"{ff}.wi_0.weight"] = (config.d_ff, d)
            s[f"{ff}.wi_1.weight"] = (config.d_ff, d)
        else:
            s[f"{ff}.wi.weight"] = (config.d_ff, d)
        s[f"{ff}.wo.weight"] = (d, config.d_ff)
        s[f"{blk}.layer.1.layer_norm.weight"] = (d,)
    s[RELATIVE_BIAS_KEY] = (config.relative_attention_num_buckets, config.num_heads)
    s["encoder.final_layer_norm.weight"] = (d,)
    return s


def init_t5_params(config: T5Config, seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32) -> Params:
    """Random init from ``seed`` (``functional.init_params``); real runs load
    pretrained weights."""
    return init_params(t5_param_shapes(config), seed, device, dtype)
