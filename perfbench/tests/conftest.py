"""CPU tests of the benchmark: `python -m pytest perfbench/tests -q`. Tests that
need the card carry the `gpu` marker and skip inside the test without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a tiny MemexQA configuration, corpus and cells (the CPU runs the plain versions)
TINY = {"config": {
    "data": {"max_albums": 2, "max_photos": 3, "max_question_len": 5, "max_answer_len": 3,
             "max_sent_len": 4, "max_album_text_len": 4, "max_word_len": 6,
             "image_feat_dim": 16, "word_emb_dim": 8, "word_vocab_size": 60,
             "char_vocab_size": 20, "num_glove_words": 40},
    "model": {"hidden_dim": 4, "char_emb_dim": 4, "char_cnn_filters": 8, "char_cnn_width": 3},
    "corpus": {"num_albums": 10, "num_photos": 20}}}
TINY_PARAMS = {"memexqa-train-b256": {"batch_size": 8, "train_questions": 32},
               "memexqa-eval-b256": {"eval_batch_size": 8, "questions": 32}}


def tiny(cell: str, **config) -> dict:
    """Overrides that shrink `cell` to a CPU size (config: more config keys)."""
    over = {"config": {k: dict(v) for k, v in TINY["config"].items()},
            "params": TINY_PARAMS[cell]}
    for section, values in config.items():
        over["config"].setdefault(section, {}).update(values)
    return over


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips inside the test when "
        "torch.cuda.is_available() is False")
