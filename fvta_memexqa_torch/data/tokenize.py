"""Deterministic tokenizer + char-id encoding.

Bit-stable because vocab ids, char ids and therefore trained checkpoints depend
on it:

- lowercase the input
- a token is either a maximal run of [a-z0-9] (with internal apostrophes kept, so
  "don't" is one token) or a single non-space, non-alphanumeric character
- chars are encoded per token, truncated/padded to `max_word_len`

`tokenize()` below is the semantic definition. A C++ scanner for the packer's
hot loop (data/_native_tokenizer.py over csrc/tokenizer.cc, built with g++ on
first use) is bit-identical to it on ASCII text: `tokenize_many` and
pack.BatchEncoder send ASCII texts there in one call and the rest through the
regex, unless FVTA_NO_NATIVE is set or the library cannot be built.
"""

from __future__ import annotations

import logging
import os
import re

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z0-9]+)*|[^a-z0-9\s]")

PAD_ID = 0
UNK_ID = 1
NUM_SPECIAL = 2  # PAD, UNK — shared by the word and char vocabularies


def tokenize(text: str) -> list[str]:
    """Lowercase word tokenization. The canonical spec — see module docstring."""
    return _WORD_RE.findall(text.lower())


def tokenize_many(texts: list[str]) -> list[list[str]]:
    """Batch tokenization: the ASCII texts through the native scanner in one
    call, the rest through the regex spec; equal to [tokenize(t) for t in
    texts]."""
    native = try_load_native()
    if native is None:
        return [tokenize(t) for t in texts]
    ascii_idx = [i for i, t in enumerate(texts) if t.isascii()]
    out: list = [None] * len(texts)
    if ascii_idx:
        for i, toks in zip(ascii_idx, native.tokenize_batch([texts[i] for i in ascii_idx])):
            out[i] = toks
    return [tokenize(t) if toks is None else toks for t, toks in zip(texts, out)]


def word_to_char_ids(word: str, char2idx: dict[str, int], max_word_len: int) -> list[int]:
    """Char ids for one token, padded/truncated to max_word_len."""
    ids = [char2idx.get(c, UNK_ID) for c in word[:max_word_len]]
    return ids + [PAD_ID] * (max_word_len - len(ids))


_NATIVE: list = []   # [module or None], once per process


def try_load_native():
    """data/_native_tokenizer with its library loaded (built on first use), or
    None when FVTA_NO_NATIVE is set or it cannot be had (the reason is logged
    once)."""
    if os.environ.get("FVTA_NO_NATIVE"):
        return None
    if not _NATIVE:
        from fvta_memexqa_torch.data import _native_tokenizer

        try:
            _native_tokenizer.library()
            _NATIVE.append(_native_tokenizer)
        except Exception as e:  # noqa: BLE001 - any failure means the regex path
            logging.getLogger(__name__).warning(
                "native tokenizer unavailable, using the regex path: %s", e)
            _NATIVE.append(None)
    return _NATIVE[0]
