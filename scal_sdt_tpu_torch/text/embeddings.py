"""Textual-inversion embeddings, consumed (port of ``scal_sdt_tpu/text/embeddings.py``).

``CustomEmbedding`` reads an embedding file (the a1111 ``.pt`` layout with
one ``string_to_param`` entry, or a ``.safetensors`` file of one tensor),
names one placeholder token per vector (``emb-<keyword>-<i>``) and rewrites
the keyword in prompts into that run of tokens. ``install_custom_embeddings``
registers the tokens and rewrites on the tokenizer and returns the CLIP
params with the vectors appended below the (frozen) token table. ``.pt``
files are read with ``torch.load(weights_only=True)``: tensors and plain
containers only.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..utils.state import infer_format

TOKEN_EMBEDDING_KEY = "text_model.embeddings.token_embedding.weight"


class CustomEmbedding:
    def __init__(self, keyword: str, vectors: np.ndarray):
        if " " in keyword:
            raise ValueError(f'Embedding "{keyword}": name cannot contain spaces')
        self.keyword = keyword
        self.vectors = np.asarray(vectors, np.float32)
        self.tokens = [f"emb-{keyword}-{i}" for i in range(len(self.vectors))]
        self.keyword_regex = re.compile(rf"(?:^|(?<=\s|,)){re.escape(keyword)}(?=,|\s|$)")
        self.keyword_replacement = " ".join(self.tokens)

    def expand_keyword(self, text: str) -> str:
        return self.keyword_regex.sub(self.keyword_replacement, text)

    @classmethod
    def load(cls, path: Path) -> "CustomEmbedding":
        path = Path(path)
        fmt = infer_format(path)
        if fmt == "pt":
            state = torch.load(path, map_location="cpu", weights_only=True)
            embs = list(state["string_to_param"].values())
            if len(embs) != 1:
                raise ValueError(f'Embedding "{path.stem}": expected one entry, got {len(embs)}')
            vectors = embs[0].detach().float().numpy()
        elif fmt == "safetensors":
            from safetensors import safe_open

            with safe_open(str(path), framework="pt") as f:
                # a1111 safetensors embeddings store a single tensor
                vectors = f.get_tensor(next(iter(f.keys()))).float().numpy()
        else:
            raise ValueError(f"Unsupported embedding file: {path}")
        return cls(path.stem, np.atleast_2d(vectors))


def load_embeddings_dir(path) -> list[CustomEmbedding]:
    return [CustomEmbedding.load(p) for p in sorted(Path(path).iterdir())
            if infer_format(p) is not None]


def install_custom_embeddings(clip_params: dict, tokenizer,
                              embeddings: Sequence[CustomEmbedding]) -> dict:
    """Register the placeholder tokens and prompt rewrites on the tokenizer;
    return the params with the extended (frozen) token table, the vectors
    cast to the table's dtype."""
    if not embeddings:
        return clip_params
    tokens = [t for e in embeddings for t in e.tokens]
    n_added = tokenizer.add_tokens(tokens)
    if n_added != len(tokens):
        raise ValueError(f"Added {n_added} tokens, expected {len(tokens)}")
    for e in embeddings:
        tokenizer.add_expansion(e.keyword_regex, e.keyword_replacement)

    table = clip_params[TOKEN_EMBEDDING_KEY]
    extra = torch.from_numpy(np.concatenate([e.vectors for e in embeddings], axis=0))
    if extra.shape[1] != table.shape[1]:
        raise ValueError(f"Embedding dim {extra.shape[1]} != model dim {table.shape[1]}")
    out = dict(clip_params)
    out[TOKEN_EMBEDDING_KEY] = torch.cat([table, extra.to(table.device, table.dtype)], dim=0)
    return out
