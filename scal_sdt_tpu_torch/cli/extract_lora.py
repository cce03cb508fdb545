"""SVD LoRA extraction (port of ``scal_sdt_tpu/cli/extract_lora.py``):

    python -m scal_sdt_tpu_torch.cli.extract_lora MODEL BASE_MODEL OUT.safetensors \\
        [--layer-spec configs/optim_targets/lora.yaml] [--ldm-config v2.yaml] [--device cuda]

The weight delta between a fine-tuned model and its base, approximated at a
low rank per layer-spec target by a truncated SVD and written in AddNet's
format. Linear and 1x1-conv targets only; a 1x1 conv's factors are stored
2-D and text-encoder modules are named ``lora_te_text_model_*``, as the
JAX tool writes them. Factors are scaled by sqrt(rank / alpha) on both sides, so
AddNet's ``(alpha / rank) * up @ down`` gives the delta back. The SVD runs
in fp32 by ``torch.linalg.svd`` on ``--device`` (the JAX tool computes it in
XLA, outside any Pallas kernel).
"""

from __future__ import annotations

import logging
from math import sqrt
from pathlib import Path
from typing import Iterator, Optional

import click
import torch

from ..conf import OPTIM_TARGETS_DIR, Config, load as conf_load, merge
from ..device import resolve_device
from ..utils.state import DTYPE_MAP, SUPPORTED_FORMATS, save_state_dict
from .ckpt_tool import check_overwrite, load_as_diffusers_state

logger = logging.getLogger("lora-approx")


def lora_approx(delta_w: torch.Tensor, rank: int, device="cuda"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-``rank`` factors of ``delta_w`` (out, in): ``down`` (rank, in),
    the leading right singular vectors, and ``up`` (out, rank), the left
    ones weighted by the singular values, so ``x @ delta.T ~= x @ down.T @
    up.T``. The SVD runs in fp32 on ``device``, on a card by cuSOLVER's
    QR-based gesvd: with torch's default solver there, the rank-16
    truncation of a trained 320x320 delta (a flat spectrum) landed 1.7e-4
    of the delta's largest entry from a float64 SVD's on an H100. The
    factors come back to the CPU."""
    dev = resolve_device(device)
    u, s, vt = torch.linalg.svd(delta_w.to(dev, torch.float32), full_matrices=False,
                                driver="gesvd" if dev.type == "cuda" else None)
    return vt[:rank].cpu(), (u[:, :rank] * s[:rank][None, :]).cpu()


def _iter_lora_leaves(nodes, prefix: str, keys, recurse_conf=None
                      ) -> Iterator[tuple[str, Config]]:
    """(path, lora config) of each layer-spec leaf that carries ``lora``."""
    def children(pfx):
        start = pfx + "." if pfx else ""
        seen = {}
        for k in keys:
            if k.startswith(start) and "." in k[len(start):]:
                seen.setdefault(k[len(start):].split(".", 1)[0])
        return list(seen)

    for node in nodes:
        node = node if isinstance(node, Config) else Config(node or {})
        own_rc = node.get("recurse_conf")
        if recurse_conf is None:
            recurse_conf = own_rc
        elif own_rc is not None:
            recurse_conf = merge(recurse_conf, own_rc)
        index = node.get("index")
        targets = node.get("targets")
        for path in (children(prefix) if index is None else list(index)):
            sub = f"{prefix}.{path}" if prefix else path
            if targets is not None:
                yield from _iter_lora_leaves(targets, sub, keys, recurse_conf)
            else:
                conf = node if recurse_conf is None else merge(node, recurse_conf)
                lora = conf.get("lora")
                if lora is not None:
                    yield sub, lora


@click.command()
@click.argument("model", type=click.Path(exists=True, path_type=Path))
@click.argument("base_model", type=click.Path(exists=True, path_type=Path))
@click.argument("output", type=click.Path(path_type=Path))
@click.option("--layer-spec", type=click.Path(exists=True, path_type=Path),
              default=OPTIM_TARGETS_DIR / "lora.yaml",
              help="Layer specification (see configs/optim_targets).")
@click.option("--overwrite", is_flag=True)
@click.option("--dtype", type=click.Choice(list(DTYPE_MAP)), default="fp16")
@click.option("--format", "fmt", type=click.Choice(SUPPORTED_FORMATS), default=None)
@click.option("--ldm-config", type=str, default=None)
@click.option("--device", default="cuda", show_default=True,
              help="Device of the SVDs ('cpu' runs without a card).")
def main(model: Path, base_model: Path, output: Path, layer_spec: Path, overwrite: bool,
         dtype: str, fmt: Optional[str], ldm_config: Optional[str], device: str):
    """Extract the (model - base_model) delta as a low-rank LoRA via SVD."""
    check_overwrite(output, overwrite)
    dev = resolve_device(device)
    layer_config = conf_load(layer_spec)

    full_unet, full_clip = load_as_diffusers_state(model, ldm_config)
    base_unet, base_clip = load_as_diffusers_state(base_model, ldm_config)
    logger.info("Weights loaded")

    state: dict = {}
    for prefix, full, base, section in [
        ("lora_unet", full_unet, base_unet, layer_config.get("unet")),
        ("lora_te_text_model", full_clip, base_clip, layer_config.get("text_encoder")),
    ]:
        if section is None:
            continue
        for path, lora_conf in _iter_lora_leaves(section.targets, "", list(full.keys())):
            w_key = f"{path}.weight"
            if w_key not in full:
                raise KeyError(f"No weight at layer-spec target {path}")
            w_full, w_base = full[w_key].float(), base[w_key].float()
            if w_full.dim() == 4:
                if tuple(w_full.shape[2:]) != (1, 1):
                    raise ValueError(f"{path}: only Linear / 1x1 Conv support LoRA")
                w_full, w_base = w_full[..., 0, 0], w_base[..., 0, 0]
            rank = int(lora_conf.get("rank", 4))
            alpha = lora_conf.get("alpha", 1)
            down, up = lora_approx(w_full - w_base, rank, dev)
            scale = sqrt(rank / float(alpha))
            # TE modules are named relative to text_model., looked up with it
            name_path = path.removeprefix("text_model.") if prefix == "lora_te_text_model" else path
            name = "_".join([prefix] + name_path.split("."))
            state[f"{name}.lora_down.weight"] = (down * scale).to(DTYPE_MAP[dtype])
            state[f"{name}.lora_up.weight"] = (up * scale).to(DTYPE_MAP[dtype])
            state[f"{name}.alpha"] = torch.tensor(int(alpha), dtype=torch.int32)

    save_state_dict(state, output, fmt)
    logger.info(f"Wrote {len(state)} tensors to {output}")


if __name__ == "__main__":
    logging.basicConfig(level="INFO")
    main()
