"""Plain reference of Stable Diffusion 3's MMDiT (diffusers'
``SD3Transformer2DModel``, arXiv:2403.03206 §2 and Fig. 2), float32, over a
flat ``{diffusers name: tensor}`` dict.

Read from ``transformer/config.json``: ``patch_size``, ``in_channels``,
``out_channels``, ``num_layers``, ``attention_head_dim``,
``num_attention_heads``, ``joint_attention_dim``, ``pooled_projection_dim``,
``pos_embed_max_size``. Patchify by a strided conv plus the centre crop of a
fixed 2-D sin-cos table; the time and pooled-text embeddings summed; the
context through one linear; then ``num_layers`` joint blocks: adaLN-Zero on
both streams (shift, scale, gate of the attention and of the MLP), one
attention over the latent tokens followed by the context tokens, the
outputs split back, gated residuals and tanh-GELU MLPs. The last block keeps
only the latent stream (its context norm is the continuous adaLN, and the
context's attention output and MLP are dropped). Then the continuous adaLN,
a linear and unpatchify. SD3-Medium has no q/k norms and no dual attention.

``checkpoint_blocks``: each joint block recomputed in the backward, so a
float32 step at 1024^2 fits beside the float32 optimizer state.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .numerics import Numerics, conv, lin, sinusoidal

POS_EMBED = "pos_embed.pos_embed"


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=1e-6)


def _mod(nx, p, name, temb, n):
    return lin(nx, p, f"{name}.linear", F.silu(temb))[:, None, :].chunk(n, dim=-1)


def _mlp(nx, p, name, x):
    return lin(nx, p, f"{name}.net.2",
               F.gelu(lin(nx, p, f"{name}.net.0.proj", x), approximate="tanh"))


def _block(nx, p, pre, x, c, temb, heads, last):
    sh, sc, gate, sh_m, sc_m, gate_m = _mod(nx, p, f"{pre}.norm1", temb, 6)
    nxh = _ln(x) * (1 + sc) + sh
    if last:
        c_sc, c_sh = _mod(nx, p, f"{pre}.norm1_context", temb, 2)
        nc = _ln(c) * (1 + c_sc) + c_sh
    else:
        c_sh, c_sc, c_gate, c_sh_m, c_sc_m, c_gate_m = _mod(nx, p, f"{pre}.norm1_context",
                                                             temb, 6)
        nc = _ln(c) * (1 + c_sc) + c_sh
    a = f"{pre}.attn"
    q = torch.cat([lin(nx, p, f"{a}.to_q", nxh), lin(nx, p, f"{a}.add_q_proj", nc)], 1)
    k = torch.cat([lin(nx, p, f"{a}.to_k", nxh), lin(nx, p, f"{a}.add_k_proj", nc)], 1)
    v = torch.cat([lin(nx, p, f"{a}.to_v", nxh), lin(nx, p, f"{a}.add_v_proj", nc)], 1)
    out = nx.heads_attention(q, k, v, heads)
    lx = x.shape[1]
    x = x + gate * lin(nx, p, f"{a}.to_out.0", out[:, :lx])
    x = x + gate_m * _mlp(nx, p, f"{pre}.ff", _ln(x) * (1 + sc_m) + sh_m)
    if last:
        return x, c
    c = c + c_gate * lin(nx, p, f"{a}.to_add_out", out[:, lx:])
    c = c + c_gate_m * _mlp(nx, p, f"{pre}.ff_context", _ln(c) * (1 + c_sc_m) + c_sh_m)
    return x, c


def sincos_table(dim: int, size: int) -> torch.Tensor:
    """(1, size*size, dim) float32 fixed 2-D sin-cos table (grid order (h, w),
    [h-embedding, w-embedding]), computed in float64."""
    def one_dim(pos):
        half = dim // 4
        omega = 1.0 / (10000.0 ** (np.arange(half, dtype=np.float64) / half))
        out = np.einsum("p,f->pf", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh, gw = np.meshgrid(np.arange(size, dtype=np.float64), np.arange(size, dtype=np.float64),
                         indexing="ij")
    return torch.from_numpy(np.concatenate([one_dim(gh), one_dim(gw)], 1)[None]
                            .astype(np.float32))


def mmdit_forward(p: dict, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                  pooled: torch.Tensor, cfg: dict, nx: Numerics,
                  checkpoint_blocks: bool = False) -> torch.Tensor:
    """x (B, C_in, H, W), timesteps (B,) in [0, 1000], context (B, L,
    joint_attention_dim), pooled (B, pooled_projection_dim) -> the velocity
    (B, C_out, H, W)."""
    b, _, h, w = x.shape
    ps, heads, size = cfg["patch_size"], cfg["num_attention_heads"], cfg["pos_embed_max_size"]
    hp, wp = h // ps, w // ps
    tok = conv(nx, p, "pos_embed.proj", x, stride=ps, padding=0).flatten(2).transpose(1, 2)
    table = p[POS_EMBED].reshape(size, size, -1)
    top, left = (size - hp) // 2, (size - wp) // 2
    tok = tok + table[top:top + hp, left:left + wp].reshape(1, hp * wp, -1)
    te = "time_text_embed"
    t = lin(nx, p, f"{te}.timestep_embedder.linear_1", sinusoidal(timesteps, 256))
    temb = lin(nx, p, f"{te}.timestep_embedder.linear_2", F.silu(t))
    y = lin(nx, p, f"{te}.text_embedder.linear_1", pooled)
    temb = temb + lin(nx, p, f"{te}.text_embedder.linear_2", F.silu(y))
    c = lin(nx, p, "context_embedder", context)
    n = cfg["num_layers"]
    for i in range(n):
        args = (nx, p, f"transformer_blocks.{i}", tok, c, temb, heads, i == n - 1)
        if checkpoint_blocks and torch.is_grad_enabled():
            args = (nx.within_checkpoint(),) + args[1:]
            tok, c = checkpoint(_block, *args, use_reentrant=False)
        else:
            tok, c = _block(*args)
    sc, sh = _mod(nx, p, "norm_out", temb, 2)
    out = lin(nx, p, "proj_out", _ln(tok) * (1 + sc) + sh)
    co = cfg["out_channels"]
    out = out.reshape(b, hp, wp, ps, ps, co)
    return out.permute(0, 5, 1, 3, 2, 4).reshape(b, co, h, w)


def mmdit_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The parameter names and shapes of the MMDiT of ``cfg`` (the sin-cos
    table under ``POS_EMBED`` included)."""
    d = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    ps, cin, cout = cfg["patch_size"], cfg["in_channels"], cfg["out_channels"]
    s: dict[str, tuple[int, ...]] = {}

    def linear(pre, cin_, cout_):
        s.update({f"{pre}.weight": (cout_, cin_), f"{pre}.bias": (cout_,)})

    s["pos_embed.proj.weight"] = (d, cin, ps, ps)
    s["pos_embed.proj.bias"] = (d,)
    s[POS_EMBED] = (1, cfg["pos_embed_max_size"] ** 2, d)
    linear("time_text_embed.timestep_embedder.linear_1", 256, d)
    linear("time_text_embed.timestep_embedder.linear_2", d, d)
    linear("time_text_embed.text_embedder.linear_1", cfg["pooled_projection_dim"], d)
    linear("time_text_embed.text_embedder.linear_2", d, d)
    linear("context_embedder", cfg["joint_attention_dim"], d)
    linear("norm_out.linear", d, 2 * d)
    linear("proj_out", d, ps * ps * cout)
    n = cfg["num_layers"]
    for i in range(n):
        pre, last = f"transformer_blocks.{i}", i == n - 1
        linear(f"{pre}.norm1.linear", d, 6 * d)
        linear(f"{pre}.norm1_context.linear", d, (2 if last else 6) * d)
        for proj in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj",
                     "to_out.0"):
            linear(f"{pre}.attn.{proj}", d, d)
        linear(f"{pre}.ff.net.0.proj", d, 4 * d)
        linear(f"{pre}.ff.net.2", 4 * d, d)
        if not last:
            linear(f"{pre}.attn.to_add_out", d, d)
            linear(f"{pre}.ff_context.net.0.proj", d, 4 * d)
            linear(f"{pre}.ff_context.net.2", 4 * d, d)
    return s
