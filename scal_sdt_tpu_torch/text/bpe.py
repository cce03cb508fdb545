"""Self-contained CLIP byte-pair-encoding tokenizer (port's copy of
``scal_sdt_tpu/text/bpe.py``, unchanged: it has no JAX in it, and the port
imports nothing of the JAX package).

Replaces the reference's hard dependency on ``transformers.CLIPTokenizer``
(``modules/text_encoders.py:34-41``): reads the standard
``vocab.json`` / ``merges.txt`` assets and reproduces CLIP's tokenization —
lowercase + whitespace normalization, the CLIP word-split regex, byte-level
unicode remapping, greedy lowest-rank pair merging with ``</w>`` end-of-word
markers — without any library. Parity with ``transformers.CLIPTokenizer`` is
enforced in ``tests/test_bpe_tokenizer.py``.

Tokenization is host-side (microseconds per batch); the device step consumes
the padded int32 ids.
"""

from __future__ import annotations

import json
import re as _std_re
from functools import lru_cache
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

try:  # CLIP's split pattern needs unicode property classes (\p{L}/\p{N})
    import regex as _re

    _WORD_PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    _WORD_PAT = _std_re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
        _std_re.IGNORECASE,
    )


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode-char table.

    Printable latin bytes map to themselves; the rest are shifted past 255 so
    no token string ever contains whitespace/control characters.
    """
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word, word[1:]))


class CLIPBPETokenizer:
    """prompts -> (B, max_length) int32 ids, CLIP semantics.

    Implements the PromptTokenizer protocol (text/tokenizer.py): BOS + ids +
    EOS, truncated and padded (pad token == EOS, like CLIP) to ``max_length``.
    """

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77):
        self.encoder = dict(vocab)
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.max_length = max_length
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        self.unk_id = self.eos_id
        self._added: dict[str, int] = {}  # textual-inversion tokens
        self._added_pat: Optional[_std_re.Pattern] = None
        self._expansions: list[tuple[_std_re.Pattern, str]] = []
        self._cache: dict[str, str] = {}

    # ------------------------------------------------------------- loading

    @classmethod
    def from_files(cls, vocab_file, merges_file, max_length: int = 77) -> "CLIPBPETokenizer":
        vocab = json.loads(Path(vocab_file).read_text(encoding="utf-8"))
        lines = Path(merges_file).read_text(encoding="utf-8").strip().split("\n")
        # First line is a version header; cap at the CLIP merge count the way
        # the standard loaders do (49152 - 256 - 2 + 1).
        merges = [tuple(line.split()) for line in lines[1: 49152 - 256 - 2 + 1]]
        return cls(vocab, merges, max_length=max_length)

    @classmethod
    def from_dir(cls, path, max_length: int = 77) -> "CLIPBPETokenizer":
        d = Path(path)
        return cls.from_files(d / "vocab.json", d / "merges.txt", max_length)

    # ----------------------------------------------------------------- api

    @property
    def vocab_size(self) -> int:
        return len(self.encoder) + len(self._added)

    def add_tokens(self, tokens: list[str]) -> int:
        """Append whole-word tokens past the vocab (textual inversion)."""
        added = 0
        for t in tokens:
            if t not in self._added and t not in self.encoder:
                self._added[t] = len(self.encoder) + len(self._added)
                added += 1
        if self._added:
            alternation = "|".join(
                _std_re.escape(t) for t in
                sorted(self._added, key=len, reverse=True))
            self._added_pat = _std_re.compile(f"({alternation})")
        return added

    def add_expansion(self, pattern: _std_re.Pattern, replacement: str):
        """Keyword -> multi-token expansion applied before tokenization
        (reference text_encoders.py:108-122 monkeypatches the tokenizer)."""
        self._expansions.append((pattern, replacement))

    # ----------------------------------------------------------------- bpe

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        pairs = _pairs(word)
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        """Content token ids (no BOS/EOS), CLIP text cleanup applied.

        Expansion and added-token extraction happen BEFORE lowercasing so
        mixed-case textual-inversion placeholders survive (the transformers
        wrapper has the same ordering: expansions on the raw prompt, added
        tokens matched pre-normalization)."""
        for pat, repl in self._expansions:
            text = pat.sub(repl, text)
        chunks = self._added_pat.split(text) if self._added_pat else [text]
        ids: list[int] = []
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self._added:
                ids.append(self._added[chunk])
                continue
            chunk = _std_re.sub(r"\s+", " ", chunk).strip().lower()
            for token in _WORD_PAT.findall(chunk):
                mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids.extend(self.encoder.get(t, self.unk_id)
                           for t in self._bpe(mapped).split(" "))
        return ids

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        out = np.full((len(prompts), self.max_length), self.eos_id, np.int32)
        out[:, 0] = self.bos_id
        for b, prompt in enumerate(prompts):
            ids = self.encode(prompt)[: self.max_length - 2]
            out[b, 1: 1 + len(ids)] = ids
            # EOS already fills the remainder (CLIP pads with EOS)
        return out
