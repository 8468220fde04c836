"""Question-category classification for per-category accuracy reporting (the
port's copy of the JAX package's data/categories.py, pure numpy).

The FVTA papers (CVPR'18 Table 2 / TPAMI'19) report MemexQA accuracy broken
down by question category — what / who / when / where / how many — derived
from the question's leading words (the dataset JSON carries no explicit type
field; SURVEY.md §6 "performance baseline"). The reference's tester prints
only overall accuracy; this module supplies the paper-table breakdown for
`cli test --by-category`.

Categories are decoded from the PACKED question ids (no re-tokenization):
pack-time meta carries `word2idx` plus the extended eval-time lexicon
(`ext_word2idx`, pack.py), so every non-UNK token round-trips to its word.
"""

from __future__ import annotations

import numpy as np

# Paper order (CVPR'18 Table 2), plus a catch-all for anything else.
QUESTION_CATEGORIES = ("what", "who", "when", "where", "how_many", "other")

_WH_WORDS = frozenset({"what", "who", "when", "where"})


def idx2word(meta: dict) -> dict[int, str]:
    """Inverse vocab map over base + extended lexicon (pack.py meta layout)."""
    inv = {int(i): w for w, i in meta["word2idx"].items()}
    inv.update({int(i): w for w, i in meta.get("ext_word2idx", {}).items()})
    return inv


def categorize(first: str, second: str = "") -> str:
    """Category of one question from its first two tokens."""
    if first == "how" and second == "many":
        return "how_many"
    if first in _WH_WORDS:
        return first
    return "other"


def question_categories(packed, split: str) -> np.ndarray:
    """Per-question category for one packed split, in dataset order.

    Dataset.get_batches(shuffle=False) iterates the split arrays in order, so
    this aligns index-for-index with eval_cache.predict_cached output.
    """
    arr = packed.splits[split]
    inv = idx2word(packed.meta)
    cats = []
    for words, mask in zip(arr["q_words"], arr["q_mask"]):
        toks = [inv.get(int(w), "") for w, m in zip(words[:2], mask[:2]) if m]
        cats.append(categorize(toks[0] if toks else "",
                               toks[1] if len(toks) > 1 else ""))
    return np.asarray(cats, dtype="U8")


def accuracy_by_category(cats: np.ndarray, correct: np.ndarray) -> dict:
    """{category: {"acc", "count"}} over present categories; paper-table rows."""
    cats = np.asarray(cats)
    correct = np.asarray(correct, dtype=bool)
    out = {}
    for c in QUESTION_CATEGORIES:
        sel = cats == c
        n = int(sel.sum())
        if n:
            out[c] = {"acc": float(correct[sel].mean()), "count": n}
    return out
