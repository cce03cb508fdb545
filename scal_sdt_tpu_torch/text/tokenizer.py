"""Prompt tokenization for the CLIP text encoder (port of
``scal_sdt_tpu/text/tokenizer.py``).

Resolved in this order:

1. ``config.tokenizer`` -- a local tokenizer directory;
2. the model's diffusers directory (``tokenizer/`` subfolder);
3. for a hub id as ``config.model``, the ``tokenizer/`` of its snapshot in
   the local HF cache (``convert/loader.py`` ``cached_snapshot``), through
   ``transformers.CLIPTokenizer`` as in the JAX package;
4. a deterministic hashing fallback for offline/test environments -- clearly
   NOT CLIP-BPE; real text training requires vocab files. The fallback keeps
   the pipeline shape-correct (BOS + ids + EOS, padded to 77).

A directory with ``vocab.json`` and ``merges.txt`` loads the native CLIP-BPE
tokenizer (``text/bpe.py``). ``tokenizer_backend: transformers`` reads it
with ``transformers.CLIPTokenizer`` instead (``CLIPTokenizerWrapper``), as
does a directory without ``merges.txt``; where ``transformers`` is not
installed, that route raises and names the package.

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


class CLIPTokenizerWrapper(PromptTokenizer):
    """``transformers.CLIPTokenizer`` behind the protocol: truncated and
    padded (with EOS) to ``max_length``."""

    def __init__(self, hf_tokenizer, max_length: Optional[int] = None):
        self.tokenizer = hf_tokenizer
        declared = hf_tokenizer.model_max_length
        # Bare vocab dirs (no tokenizer_config.json) leave transformers'
        # VERY_LARGE_INTEGER sentinel in place: fall back to CLIP's 77.
        if declared is None or declared > 1_000_000:
            declared = MODEL_MAX_LENGTH
        self.max_length = max_length or declared
        self.vocab_size = len(hf_tokenizer)
        self._expansions: list[tuple[re.Pattern, str]] = []

    @classmethod
    def from_path(cls, path) -> "CLIPTokenizerWrapper":
        try:
            from transformers import CLIPTokenizer
        except ImportError as e:
            raise ImportError(
                f"{path}: the transformers tokenizer backend needs the `transformers` "
                "package, which is not installed; give a directory with vocab.json and "
                "merges.txt to the native tokenizer (tokenizer_backend: native)") from e
        return cls(CLIPTokenizer.from_pretrained(str(path)))

    def add_expansion(self, pattern: re.Pattern, replacement: str):
        """Textual-inversion keyword expansion: a pre-tokenization rewrite."""
        self._expansions.append((pattern, replacement))

    def add_tokens(self, tokens: list[str]) -> int:
        n = self.tokenizer.add_tokens(tokens)
        self.vocab_size = len(self.tokenizer)
        return n

    def __call__(self, prompts: Sequence[str]) -> np.ndarray:
        prompts = list(prompts)
        for pat, repl in self._expansions:
            prompts = [pat.sub(repl, p) for p in prompts]
        out = self.tokenizer(prompts, truncation=True, max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        return out.input_ids.astype(np.int32)


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

    use_transformers = str(config.get("tokenizer_backend", "native")) == "transformers"
    for cand in candidates:
        if cand.is_dir() and (cand / "vocab.json").exists():
            logger.info(f"Loading tokenizer from {cand}")
            if use_transformers or not (cand / "merges.txt").exists():
                return CLIPTokenizerWrapper.from_path(cand)
            from .bpe import CLIPBPETokenizer

            return CLIPBPETokenizer.from_dir(cand)

    if model and not Path(str(model)).exists():
        from ..convert.loader import cached_snapshot

        snapshot = cached_snapshot(str(model))
        if snapshot is not None:
            try:
                return CLIPTokenizerWrapper.from_path(snapshot / "tokenizer")
            except Exception as e:  # noqa: BLE001 - JAX's route falls through too
                logger.warning(f"no tokenizer from {snapshot / 'tokenizer'} "
                               f"({type(e).__name__}: {e})")

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
