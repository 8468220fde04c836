"""ctypes binding for the native batch tokenizer (csrc/tokenizer.cc, a copy of
the repo's native/tokenizer.cc): the packer's fast path, bit-identical to the
regex spec of data/tokenize.py on ASCII text.

The library is built on first use, not at import: `g++ -O3 -std=c++17 -shared
-fPIC` into fvta_memexqa_torch/_build/ under a name carrying the source's hash,
atomically (utils/native_build, as ops/build.py builds the kernels), so
concurrent processes build it once and none can load a half-written file.
`library()` raises when it cannot be had;
data/tokenize.try_load_native turns that into "use the regex path".
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from fvta_memexqa_torch.utils.native_build import build_missing, hashed_target

SRC = Path(__file__).resolve().parent.parent / "csrc" / "tokenizer.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def build_library(build_dir: Path | None = None) -> Path:
    """Path of the built library in `build_dir` (default BUILD_DIR), building it
    if missing."""
    build_dir = Path(build_dir or BUILD_DIR)
    out = hashed_target(build_dir, "_libfvta_tokenizer", SRC.read_bytes(),
                        " ".join(GXX_FLAGS).encode())
    if not out.exists():
        build_missing({SRC.name: (["g++", *GXX_FLAGS, str(SRC)], out)},
                      build_dir / ".tokenizer.lock")
    return out


def library(build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded library (built on first use), with its argument types."""
    with _lock:
        path = build_library(build_dir)
        if path not in _libs:
            lib = ctypes.CDLL(str(path))
            i64, i32, p = ctypes.c_int64, ctypes.c_int32, ctypes.POINTER
            lib.fvta_tokenize_batch.restype = i64
            lib.fvta_tokenize_batch.argtypes = [ctypes.c_char_p, p(i64), i64, p(i64), p(i32),
                                                p(i32), i64]
            lib.fvta_vocab_create.restype = ctypes.c_void_p
            lib.fvta_vocab_create.argtypes = [ctypes.c_char_p, p(i64), p(i32), i64]
            lib.fvta_vocab_destroy.argtypes = [ctypes.c_void_p]
            lib.fvta_encode_batch.restype = None
            lib.fvta_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, p(i64), i64,
                                              i32, i32, p(i32), i32, p(i32), p(i32),
                                              p(ctypes.c_uint8)]
            _libs[path] = lib
        return _libs[path]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _offsets(blobs: list[bytes]) -> np.ndarray:
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    return offsets


def tokenize_batch(texts: list[str]) -> list[list[str]]:
    """Tokenize many ASCII documents in one native call.

    The caller guarantees every text is ASCII (`str.isascii()`); text is
    lowercased here so the semantics match data/tokenize.tokenize exactly."""
    lib = library()
    blobs = [t.lower().encode("ascii") for t in texts]
    offsets = _offsets(blobs)
    buf = b"".join(blobs)
    max_tokens = max(len(buf), 1)
    starts = np.zeros(max_tokens, dtype=np.int64)
    lens = np.zeros(max_tokens, dtype=np.int32)
    counts = np.zeros(len(blobs), dtype=np.int32)
    n = lib.fvta_tokenize_batch(buf, _ptr(offsets, ctypes.c_int64), len(blobs),
                                _ptr(starts, ctypes.c_int64), _ptr(lens, ctypes.c_int32),
                                _ptr(counts, ctypes.c_int32), max_tokens)
    text = buf.decode("ascii")
    starts_l, lens_l = starts[:n].tolist(), lens[:n].tolist()
    out: list[list[str]] = []
    pos = 0
    for c in counts.tolist():
        out.append([text[starts_l[k]:starts_l[k] + lens_l[k]] for k in range(pos, pos + c)])
        pos += c
    assert pos == n
    return out


def tokenize(text: str) -> list[str]:
    return tokenize_batch([text])[0]


class NativeEncoder:
    """Tokenize + vocab/char-id encode entire text batches in one native call.

    Bit-identical to the regex path (pack._encode_text over data/tokenize.tokenize)
    for ASCII input; the caller routes non-ASCII texts to the regex path."""

    def __init__(self, word2idx: dict[str, int], char2idx: dict[str, int],
                 unk_id: int = 1):
        self._lib = library()
        words = [w for w in word2idx if w.isascii()]
        blobs = [w.encode("ascii") for w in words]
        ids = np.array([word2idx[w] for w in words], dtype=np.int32)
        offsets = _offsets(blobs)
        self._handle = self._lib.fvta_vocab_create(b"".join(blobs), _ptr(offsets, ctypes.c_int64),
                                                   _ptr(ids, ctypes.c_int32), len(words))
        self._char_table = np.full(256, unk_id, dtype=np.int32)
        for ch, cid in char2idx.items():
            if len(ch) == 1 and ch.isascii():
                self._char_table[ord(ch)] = cid
        self._unk = unk_id

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fvta_vocab_destroy(handle)
            self._handle = None

    def encode_batch(self, texts: list[str], max_len: int, max_word_len: int):
        """→ (word_ids i32 [N, L], char_ids i32 [N, L, W], mask bool [N, L])."""
        blobs = [t.lower().encode("ascii") for t in texts]
        offsets = _offsets(blobs)
        n = len(blobs)
        words = np.zeros((n, max_len), dtype=np.int32)
        chars = np.zeros((n, max_len, max_word_len), dtype=np.int32)
        mask = np.zeros((n, max_len), dtype=np.uint8)
        self._lib.fvta_encode_batch(self._handle, b"".join(blobs), _ptr(offsets, ctypes.c_int64),
                                    n, max_len, max_word_len,
                                    _ptr(self._char_table, ctypes.c_int32), self._unk,
                                    _ptr(words, ctypes.c_int32), _ptr(chars, ctypes.c_int32),
                                    _ptr(mask, ctypes.c_uint8))
        return words, chars, mask.astype(bool)
