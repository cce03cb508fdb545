"""Prompt tokenization for the CLIP text encoder (port of
``scal_sdt_tpu/text/tokenizer.py``).

Resolved in this order:

1. ``config.tokenizer`` -- a local tokenizer directory;
2. the model's diffusers directory (``tokenizer/`` subfolder);
3. a deterministic hashing fallback for offline/test environments -- clearly
   NOT CLIP-BPE; real text training requires vocab files. The fallback keeps
   the pipeline shape-correct (BOS + ids + EOS, padded to 77).

A directory with ``vocab.json`` and ``merges.txt`` loads the native CLIP-BPE
tokenizer (``text/bpe.py``). Not ported yet, and refused with an error: the
``tokenizer_backend: transformers`` route, a vocab directory without
``merges.txt`` (which only transformers reads), and a hub id as
``config.model`` (the JAX package downloads its tokenizer).

SD3's third tokenizer (T5's SentencePiece unigram, ``T5TokenizerWrapper``,
found by ``resolve_t5_tokenizer``) runs on the ``tokenizers`` package over
``tokenizer_3/tokenizer.json``, imported only when such a file is found.

Tokenization is host-side: the device step consumes int32 ids.
"""

from __future__ import annotations

import logging
import re
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger("tokenizer")

BOS_ID = 49406
EOS_ID = 49407
MODEL_MAX_LENGTH = 77


class PromptTokenizer:
    """Protocol: prompts -> (B, max_length) int32 ids."""

    max_length: int = MODEL_MAX_LENGTH
    vocab_size: int = 49408

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def add_tokens(self, tokens: list[str]) -> int:
        raise NotImplementedError


class T5TokenizerWrapper(PromptTokenizer):
    """SD3's third tokenizer (T5's SentencePiece unigram) on the
    ``tokenizers`` runtime over ``tokenizer_3/tokenizer.json``.

    T5's rules: no BOS; EOS (``</s>``, id 1) appended by the file's own
    post-processor; padded with id 0 to ``max_length``; truncated. diffusers
    calls this length ``max_sequence_length`` (77 in the SD3 fine-tuning
    recipes, 256 at inference); the config key is ``t5_max_length``."""

    def __init__(self, tokenizer, max_length: int = MODEL_MAX_LENGTH, pad_id: int = 0):
        self.tokenizer = tokenizer
        self.max_length = int(max_length)
        self.vocab_size = tokenizer.get_vocab_size()
        tokenizer.enable_truncation(self.max_length)
        tokenizer.enable_padding(length=self.max_length, pad_id=pad_id)

    @classmethod
    def from_file(cls, path, max_length: int = MODEL_MAX_LENGTH) -> "T5TokenizerWrapper":
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                f"{path}: the T5 tokenizer (tokenizer_3) needs the `tokenizers` package, "
                "which is not installed; install it, train from a condition cache, or "
                "remove text_encoder_3/ from the model directory") from e
        return cls(Tokenizer.from_file(str(path)), max_length=max_length)

    def add_tokens(self, tokens: list[str]) -> int:
        n = self.tokenizer.add_tokens(list(tokens))
        self.vocab_size = self.tokenizer.get_vocab_size()
        return n

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        encs = self.tokenizer.encode_batch(list(prompts))
        return np.asarray([e.ids for e in encs], np.int32)


def resolve_t5_tokenizer(config, t5_max_length: int = MODEL_MAX_LENGTH
                         ) -> Optional[T5TokenizerWrapper]:
    """``tokenizer_3/tokenizer.json`` under the model directory (or the
    ``tokenizer_3:`` config key). None when absent: the caller decides
    whether T5 conditioning without a tokenizer is an error (live training)
    or fine (cache-backed runs). Raises, naming the package, when a file is
    found and ``tokenizers`` is not installed."""
    candidates = []
    declared = config.get("tokenizer_3")
    if declared:
        candidates.append(Path(str(declared)))
    model = config.get("model")
    if model and Path(str(model)).is_dir():
        candidates.append(Path(str(model)) / "tokenizer_3")
    for cand in candidates:
        f = cand / "tokenizer.json" if cand.is_dir() else cand
        if f.exists():
            logger.info(f"Loading T5 tokenizer from {f}")
            return T5TokenizerWrapper.from_file(
                f, max_length=int(config.get("t5_max_length") or t5_max_length))
    return None


class HashTokenizer(PromptTokenizer):
    """Deterministic stand-in when no CLIP vocab exists on disk."""

    def __init__(self, vocab_size: int = 49408, max_length: int = MODEL_MAX_LENGTH):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._extra: dict[str, int] = {}
        self._expansions: list[tuple[re.Pattern, str]] = []

    def add_expansion(self, pattern: re.Pattern, replacement: str):
        self._expansions.append((pattern, replacement))

    def add_tokens(self, tokens: list[str]) -> int:
        for t in tokens:
            if t not in self._extra:
                self._extra[t] = self.vocab_size
                self.vocab_size += 1
        return len(tokens)

    def _word_id(self, word: str) -> int:
        if word in self._extra:
            return self._extra[word]
        return zlib.crc32(word.encode()) % (BOS_ID - 1) + 1

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        prompts = list(prompts)
        for pat, repl in self._expansions:
            prompts = [pat.sub(repl, p) for p in prompts]
        ids = np.full((len(prompts), self.max_length), EOS_ID, np.int32)
        for b, prompt in enumerate(prompts):
            words = re.findall(r"[^\s,]+", prompt.lower())[: self.max_length - 2]
            ids[b, 0] = BOS_ID
            for i, w in enumerate(words):
                ids[b, i + 1] = self._word_id(w)
        return ids


def resolve_tokenizer(config, allow_hash: Optional[bool] = None) -> PromptTokenizer:
    """Resolve per the priority list in the module docstring.

    ``tokenizer: hash`` opts into the hashing stand-in explicitly. Otherwise,
    when no vocab assets exist, this FAILS unless ``allow_hash`` is true
    (for runs that never consume prompt ids, such as caching latents only):
    silently training with hash tokens would destroy text conditioning.
    """
    declared = config.get("tokenizer")
    if str(declared).lower() == "hash":
        logger.info("Using the hashing tokenizer (explicitly configured)")
        return HashTokenizer()

    candidates = []
    if declared:
        candidates.append(Path(str(declared)))
    model = config.get("model")
    if model and Path(str(model)).is_dir():
        candidates.append(Path(str(model)) / "tokenizer")

    if str(config.get("tokenizer_backend", "native")) == "transformers":
        raise NotImplementedError(
            "tokenizer_backend: transformers is not ported yet; the native CLIP-BPE "
            "tokenizer reads the same vocab.json / merges.txt")
    for cand in candidates:
        if cand.is_dir() and (cand / "vocab.json").exists():
            if not (cand / "merges.txt").exists():
                raise NotImplementedError(
                    f"{cand} has vocab.json but no merges.txt: only the transformers "
                    "backend reads it, which is not ported yet")
            from .bpe import CLIPBPETokenizer

            logger.info(f"Loading tokenizer from {cand}")
            return CLIPBPETokenizer.from_dir(cand)

    if model and not Path(str(model)).exists():
        raise NotImplementedError(
            f"model {model!r} is not a local path: hub ids are not ported yet; pass a "
            "local diffusers directory")

    if not allow_hash:
        raise RuntimeError(
            "No CLIP tokenizer vocab found (config.tokenizer / <model>/tokenizer) "
            "and this run consumes prompts. Provide vocab.json/merges.txt, or set "
            "`tokenizer: hash` to explicitly accept non-CLIP hash tokens.")
    logger.warning(
        "No CLIP tokenizer vocab found (config.tokenizer / <model>/tokenizer). "
        "Using the deterministic hashing fallback: fine for pipeline tests and "
        "cached-latent training, NOT for real text conditioning.")
    return HashTokenizer()
