"""The port's native tokenizer (data/_native_tokenizer.py over csrc/tokenizer.cc)
against the JAX package's regex route (tests/test_native_tokenizer.py's cases):
`tokenize`, `_encode_text` and `BatchEncoder` of fvta_memexqa_tpu with
FVTA_NO_NATIVE=1, so the JAX package's own native module is never loaded here.
Also: the source is native/tokenizer.cc byte for byte, FVTA_NO_NATIVE turns the
port's native route off, a pack made through it equals the regex route's (and
JAX's) array for array, and six processes building into one fresh directory at
once all load a whole library, and a failed build publishes nothing."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fvta_memexqa_tpu.data import load_pack as j_load_pack
from fvta_memexqa_tpu.data import pack as j_pack
from fvta_memexqa_tpu.data.pack import BatchEncoder as JBatchEncoder
from fvta_memexqa_tpu.data.pack import _encode_text as j_encode_text
from fvta_memexqa_tpu.data.tokenize import tokenize as j_tokenize
from fvta_memexqa_tpu.data.vocab import Vocab as JVocab

from fvta_memexqa_torch.data import _native_tokenizer as nt
from fvta_memexqa_torch.data import load_pack, make_synthetic, pack
from fvta_memexqa_torch.data.tokenize import tokenize_many, try_load_native
from fvta_memexqa_torch.data.pack import BatchEncoder
from fvta_memexqa_torch.data.vocab import Vocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ["", "   ", "Hello, World!", "don't stop believin'", "July 4, 2007 (10:30) -- a.m.!!",
         "a'b'c'd", "'leading and trailing'", "x" * 500, "a  b\t\nc\r d",
         "rock&roll 100% [fun]", "it's-a-me", "o'' ''o"]


@pytest.fixture(autouse=True)
def jax_regex_route(monkeypatch):
    """The JAX package reads FVTA_NO_NATIVE at each call: set while its
    functions run (jax_regex), unset for the port's."""
    monkeypatch.delenv("FVTA_NO_NATIVE", raising=False)


def jax_regex(fn, *args):
    os.environ["FVTA_NO_NATIVE"] = "1"
    try:
        return fn(*args)
    finally:
        del os.environ["FVTA_NO_NATIVE"]


def test_source_is_the_repos_native_tokenizer_byte_for_byte():
    with open(os.path.join(ROOT, "native", "tokenizer.cc"), "rb") as a, open(nt.SRC, "rb") as b:
        assert a.read() == b.read()


def test_native_route_loads_and_the_switch_turns_it_off(monkeypatch):
    assert try_load_native() is nt
    monkeypatch.setenv("FVTA_NO_NATIVE", "1")
    assert try_load_native() is None
    assert BatchEncoder(Vocab.build(["a"], None, dim=4, seed=0))._enc is None


@pytest.mark.parametrize("text", CASES)
def test_cases_match_jax_regex(text):
    assert nt.tokenize(text) == j_tokenize(text)


def test_fuzz_ascii_matches_jax_regex():
    rng = np.random.default_rng(0)
    # control chars: \x1c-\x1f are \s to Python's re, \x00-\x02 are not
    alphabet = list("abcXYZ019 \t'.,!?-_()&/\\\"\x1c\x1d\x1e\x1f\x00\x01\x02")
    texts = ["".join(rng.choice(alphabet) for _ in range(int(rng.integers(0, 60))))
             for _ in range(300)]
    assert nt.tokenize_batch(texts) == [j_tokenize(t) for t in texts]
    assert tokenize_many(texts + CASES) == [j_tokenize(t) for t in texts + CASES]


def test_tokenize_many_routes_mixed_unicode():
    texts = ["ascii only here", "café naïve", "日本語 text", "plain 2007!"]
    assert tokenize_many(texts) == [j_tokenize(t) for t in texts]


@pytest.mark.parametrize("words,texts,max_len,word_len", [
    (["zebra", "photo", "july", "2007", "don't", "a", "of", ",", "!"],
     CASES + ["A photo of a ZEBRA, July 2007! Don't miss it."], 12, 6),
    (["photo", "of", "zebra", "café", "über"],
     ["a photo of zebra", "café über alles ☃", "photo photo", "", "zébra photo"], 8, 6),
])
def test_batch_encoder_matches_jax_regex(words, texts, max_len, word_len):
    """BatchEncoder's native route (ASCII texts in one call, the rest through
    the regex) vs the JAX package's BatchEncoder and _encode_text with
    FVTA_NO_NATIVE; UNK tokens carry PAD chars."""
    vocab, j_vocab = Vocab.build(words * 2, None, dim=4, seed=0), \
        JVocab.build(words * 2, None, dim=4, seed=0)
    enc = BatchEncoder(vocab)
    assert enc._enc is not None
    got = enc.encode(texts, max_len, word_len)
    want = jax_regex(lambda: JBatchEncoder(j_vocab).encode(texts, max_len, word_len))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for i, t in enumerate(texts):
        w, c, m = j_encode_text(j_tokenize(t), j_vocab, max_len, word_len)
        np.testing.assert_array_equal(got[0][i], w, err_msg=repr(t))
        np.testing.assert_array_equal(got[1][i], c, err_msg=repr(t))
        np.testing.assert_array_equal(got[2][i], m, err_msg=repr(t))
    assert (got[1][got[0] == 1] == 0).all()


def test_pack_through_the_native_route_equals_the_regex_routes(tmp_path, monkeypatch):
    from conftest import small_data_config

    args = make_synthetic(seed=0)
    native_dir, regex_dir, jax_dir = (str(tmp_path / k) for k in ("n", "r", "j"))
    pack(*args, native_dir, small_data_config(), seed=0)
    monkeypatch.setenv("FVTA_NO_NATIVE", "1")
    pack(*args, regex_dir, small_data_config(), seed=0)
    j_pack(*args, jax_dir, small_data_config(), seed=0)
    packs = (load_pack(native_dir), load_pack(regex_dir), j_load_pack(jax_dir))
    for other in packs[1:]:
        for k in vars(packs[0].shared):
            np.testing.assert_array_equal(getattr(packs[0].shared, k),
                                          getattr(other.shared, k), err_msg=k)
        for split in packs[0].splits:
            for k in packs[0].splits[split]:
                np.testing.assert_array_equal(packs[0].splits[split][k],
                                              other.splits[split][k], err_msg=f"{split}/{k}")


BUILD_AND_TOKENIZE = """
import sys
from pathlib import Path
from fvta_memexqa_torch.data import _native_tokenizer as nt
nt.BUILD_DIR = Path(sys.argv[1])
print(nt.build_library())
print(nt.tokenize_batch(["Don't stop, 2007!", "a.b"]))
"""


def test_six_processes_building_at_once_each_load_a_whole_library(tmp_path):
    """Six processes build into one fresh directory at the same moment: the
    lock and the rename let one compile, and every one loads the same whole
    library and tokenizes with it."""
    build_dir = str(tmp_path / "fresh")
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_TOKENIZE, build_dir], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    lines = {out for out, _ in outs}
    assert len(lines) == 1
    path, tokens = lines.pop().splitlines()
    assert tokens == repr([j_tokenize("Don't stop, 2007!"), j_tokenize("a.b")])
    assert sorted(os.listdir(build_dir)) == sorted([".tokenizer.lock", os.path.basename(path)])


def test_a_failed_build_names_its_job_and_publishes_nothing(tmp_path):
    """utils/native_build (the kernels' and the tokenizer's build): a compiler
    error raises with the job's name and output, leaves neither the target nor
    its temporary file, and a later good build publishes the library."""
    from fvta_memexqa_torch.utils.native_build import build_missing, hashed_target

    src = tmp_path / "unit.cc"
    src.write_text("int broken = ;\n")
    out = hashed_target(tmp_path / "b", "unit", src.read_bytes())
    cmd = ["g++", "-shared", "-fPIC", str(src)]
    with pytest.raises(RuntimeError, match=r"unit \(exit 1\)"):
        build_missing({"unit": (cmd, out)}, tmp_path / "b" / ".lock")
    assert os.listdir(tmp_path / "b") == [".lock"]
    src.write_text('extern "C" int unit_answer() { return 42; }\n')
    good = hashed_target(tmp_path / "b", "unit", src.read_bytes())
    assert good != out
    logs = build_missing({"unit": (cmd, good)}, tmp_path / "b" / ".lock")
    assert set(logs) == {"unit"} and good.exists()
    assert build_missing({"unit": (cmd, good)}, tmp_path / "b" / ".lock") == {}
