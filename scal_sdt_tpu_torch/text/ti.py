"""Textual-inversion training (port of ``scal_sdt_tpu/text/ti.py``).

The trained placeholder vectors live in their own trainable leaf
(``TRAINED_EXTRA_KEY``), which ``models/clip.py`` appends below the frozen
token table: gradients reach only the new rows, and the leaf rides the usual
checkpoint and resume. Config::

    custom_embeddings:
      train:
        enabled: true
        lr: 5.0e-3                    # own optimizer group, no weight decay
        tokens:
          - keyword: my-cat           # appears in captions
            vectors_per_token: 4
            init: cat                 # seed from this word's embedding(s)

The vectors start from the mean of the init word's token rows, or from
``np.random.RandomState(seed)`` draws times 0.01, as in the JAX package,
bit for bit. ``export_embeddings`` slices the trained rows per keyword into
a1111-layout safetensors files.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .embeddings import TOKEN_EMBEDDING_KEY, CustomEmbedding

logger = logging.getLogger("ti")

TRAINED_EXTRA_KEY = "text_model.embeddings.token_embedding.trained_extra"


@dataclasses.dataclass(frozen=True)
class TITokenSpec:
    keyword: str
    vectors_per_token: int = 1
    init: Optional[str] = None  # word to seed from; None: small random


def parse_ti_specs(train_config) -> list[TITokenSpec]:
    specs = [TITokenSpec(keyword=str(entry["keyword"]),
                         vectors_per_token=int(entry.get("vectors_per_token", 1)),
                         init=entry.get("init"))
             for entry in train_config.get("tokens") or []]
    if not specs:
        raise ValueError("custom_embeddings.train.enabled with no tokens")
    return specs


def _init_vectors(spec: TITokenSpec, table: np.ndarray, tokenizer,
                  rng: np.random.RandomState) -> np.ndarray:
    d = table.shape[1]
    if spec.init:
        ids = np.asarray(tokenizer([spec.init]))[0]
        # CLIP layout: [bos, content..., eos, eos...]; the pad is the trailing
        # id: strip bos and every pad/eos
        pad = ids[-1]
        content = [int(i) for i in ids[1:] if i != pad]
        if content:
            seed = table[content].mean(axis=0)
            return np.tile(seed, (spec.vectors_per_token, 1)).astype(np.float32)
        logger.warning(f'TI "{spec.keyword}": init word {spec.init!r} tokenized to nothing; '
                       "falling back to random init")
    return (rng.randn(spec.vectors_per_token, d) * 0.01).astype(np.float32)


def setup_ti_training(clip_params: dict, tokenizer, specs: Sequence[TITokenSpec],
                      seed: int = 0) -> tuple[dict, list[dict]]:
    """Register the placeholder tokens and prompt rewrites; return the params
    with the fp32 ``trained_extra`` leaf (on the table's device) and the
    export metadata ``[{keyword, n_vectors}, ...]`` (rows in list order)."""
    rng = np.random.RandomState(seed)
    table_t = clip_params[TOKEN_EMBEDDING_KEY]
    table = table_t.detach().float().cpu().numpy()

    blocks, meta = [], []
    for spec in specs:
        emb = CustomEmbedding(spec.keyword,
                              np.zeros((spec.vectors_per_token, table.shape[1]), np.float32))
        n_added = tokenizer.add_tokens(emb.tokens)
        if n_added != len(emb.tokens):
            raise ValueError(f'TI "{spec.keyword}": token collision ({n_added}/'
                             f"{len(emb.tokens)} added)")
        tokenizer.add_expansion(emb.keyword_regex, emb.keyword_replacement)
        blocks.append(_init_vectors(spec, table, tokenizer, rng))
        meta.append({"keyword": spec.keyword, "n_vectors": spec.vectors_per_token})
        logger.info(f'TI training "{spec.keyword}": {spec.vectors_per_token} vector(s), '
                    f"init={spec.init or 'random'}")

    out = dict(clip_params)
    out[TRAINED_EXTRA_KEY] = torch.from_numpy(np.concatenate(blocks, axis=0)).to(table_t.device)
    return out, meta


def register_ti_tokens_for_inference(tokenizer, ti_meta: Sequence[dict]) -> None:
    """Register the placeholder tokens and rewrites of a checkpoint's
    ``ti_tokens`` metadata, so prompts with the trained keywords resolve."""
    for entry in ti_meta:
        emb = CustomEmbedding(entry["keyword"], np.zeros((int(entry["n_vectors"]), 1), np.float32))
        tokenizer.add_tokens(emb.tokens)
        tokenizer.add_expansion(emb.keyword_regex, emb.keyword_replacement)


def export_embeddings(extra: torch.Tensor, ti_meta: Sequence[dict], out_dir) -> list[Path]:
    """One a1111-layout safetensors file (a single ``emb_params`` tensor) per
    keyword, sliced from the ``trained_extra`` rows."""
    from ..utils.state import save_state_dict

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    extra = torch.as_tensor(extra).detach().cpu()
    written, off = [], 0
    for entry in ti_meta:
        n = int(entry["n_vectors"])
        path = out_dir / f"{entry['keyword']}.safetensors"
        save_state_dict({"emb_params": extra[off:off + n].contiguous()}, path)
        written.append(path)
        off += n
    if off != len(extra):
        raise ValueError(f"ti_tokens metadata covers {off} rows, checkpoint has {len(extra)}")
    return written
