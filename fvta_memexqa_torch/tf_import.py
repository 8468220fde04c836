"""TF checkpoints in and out of the port, without TensorFlow.

The reference is a TF1 `tf.train.Saver` codebase, so its weights, the day they
appear, come as a TF checkpoint. This module maps such a checkpoint onto the
model's parameters, and back:

- the mapping layer is the JAX package's (`default_tf1_map`, `convert_params`),
  with the same names, report keys and error text. Its keys are the flax leaf
  paths (`enc_word/fw`, `highway/h0/kernel`, ...), so a `--dump-map` file or a
  hand-edited `--map` file works with either package; convert.py's
  `flax_tree_from_state_dict` / `state_dict_from_flax` go between those paths
  and the port's modules.
  - TF1 `BasicLSTMCell` layout: ONE fused [D+H, 4H] kernel with gate blocks in
    (i, j, f, o) order and the forget bias added in the cell, as
    ops/lstm_ref.py has them: the import is a row split (wx = kernel[:D],
    wh = kernel[D:], b = bias), bitwise.
  - Keras `LSTM` layout: separate kernel / recurrent / bias with gate blocks in
    (i, f, c, o) order and the forget bias folded into the bias: reordered and
    unfolded (exact up to the one float32 subtraction).
  A mapping value of null keeps that leaf at its initialized value.
- `read_tf_checkpoint` reads a TF V2 tensor bundle (what `tf.train.Saver`
  writes by default since TF 1.0, and what `tf.train.Checkpoint` writes): the
  `<prefix>.index` file is a LevelDB-format table (blocks of prefix-compressed
  keys with restart points, each block followed by a compression byte and a
  masked CRC32C, and a 48-byte footer ending in the table magic) that maps ""
  to a BundleHeaderProto and every tensor name to a BundleEntryProto (dtype,
  shape, shard, offset, size, masked CRC32C); `<prefix>.data-0000i-of-0000n`
  hold the raw little-endian tensor bytes. The protobufs are decoded by hand
  and every CRC32C read is checked (table-driven, in Python).
  What it does not read, where `tf.train.load_checkpoint` does: Saver V1
  checkpoints (one table file of SavedTensorSlices at the prefix), partitioned
  (sliced) variables, and dtypes past the list in `_DTYPES`; each raises a
  ValueError that names the format. DT_BFLOAT16 tensors come back as float32
  (numpy has no bfloat16; the upcast is exact).
- `export_tf1_checkpoint` writes the model's parameters as a TF1-layout Saver
  checkpoint: `<path>.index` and `<path>.data-00000-of-00001`, byte for byte
  what `tf.train.Saver.save` writes for the same tensors (single shard, the
  table options and header version of TF's BundleWriter), and the
  `checkpoint` state file beside them. It writes no `.meta` graph: building a
  GraphDef needs TensorFlow.

CLI: python -m fvta_memexqa_torch.cli import-tf-checkpoint <ckpt> <packdir> <rundir>
(a port run directory at step 0, so `cli test <packdir> <rundir>` evaluates the
imported weights), and export-tf-checkpoint <packdir> <rundir> <out_prefix>.
"""

from __future__ import annotations

import os
import struct
from collections.abc import Mapping

import numpy as np

from fvta_memexqa_torch.ops.lstm_ref import LSTMParams

LSTM_ENCODERS = ("enc_word", "enc_photo", "enc_photo_title", "enc_album_title",
                 "enc_album_desc", "enc_when", "enc_where")

# Non-LSTM leaves, as "a/b/c" paths into the flax params["params"] tree.
PLAIN_LEAVES = (
    "word_embed/oov_emb",
    "char_cnn/char_emb", "char_cnn/conv_kernel", "char_cnn/conv_bias",
    "highway/h0/kernel", "highway/h0/bias",
    "highway/g0/kernel", "highway/g0/bias",
    "highway/h1/kernel", "highway/h1/bias",
    "highway/g1/kernel", "highway/g1/bias",
    "photo_proj/kernel", "photo_proj/bias",
    "sim_w_x", "sim_w_y", "sim_w_xy",      # trilinear similarity
    "sim_w_bilinear",                      # bilinear similarity
    "scorer/kernel", "scorer/bias",
)


def default_tf1_map(prefix: str = "model") -> dict:
    """Plausible tf.train.Saver names for the reference's TF1 graph.

    An unverified guess (no reference weights exist to check it against):
    per-modality variable scopes wrapping `tf.nn.bidirectional_dynamic_rnn` +
    `BasicLSTMCell` produce `<scope>/bidirectional_rnn/{fw,bw}/basic_lstm_cell/
    {kernel,bias}`; dense layers produce `<scope>/{kernel,bias}`. Regenerate
    with --dump-map and edit against --list output when real weights are
    available."""
    m: dict = {}
    for enc in LSTM_ENCODERS:
        for d in ("fw", "bw"):
            m[f"{enc}/{d}"] = {
                "kernel": f"{prefix}/{enc}/bidirectional_rnn/{d}/basic_lstm_cell/kernel",
                "bias": f"{prefix}/{enc}/bidirectional_rnn/{d}/basic_lstm_cell/bias",
                "layout": "tf1",
            }
    for leaf in PLAIN_LEAVES:
        m[leaf] = f"{prefix}/{leaf}"
    return m


# ---- CRC32C (Castagnoli), masked as TF and LevelDB store it ------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()
_MASK_DELTA = 0xA282EAD8


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of `data`, extending `crc` (the CRC32C of the bytes before it)."""
    table = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _mask(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


# ---- protobuf wire format (varints, length-delimited fields) -----------------------

def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in a TF checkpoint")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _put_varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _fields(buf: bytes) -> list[tuple[int, int | bytes]]:
    """(field number, value) of each field of a protobuf message: an int for
    varint and fixed fields, bytes for length-delimited ones."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = struct.unpack_from("<Q", buf, pos)[0], pos + 8
        elif wire == 5:
            value, pos = struct.unpack_from("<I", buf, pos)[0], pos + 4
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire} in a TF checkpoint")
        out.append((field, value))
    return out


def _field(key_field: int, value: int | bytes, wire: int) -> bytes:
    head = _put_varint(key_field << 3 | wire)
    if wire == 0:
        return head + _put_varint(value)
    if wire == 5:
        return head + struct.pack("<I", value)
    return head + _put_varint(len(value)) + value


# ---- the tensor bundle's protos -----------------------------------------------------

# tensorflow/core/framework/types.proto: DataType → numpy dtype. DT_BFLOAT16 is
# read as float32 (exact); DT_STRING as an object array of bytes.
_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16, 6: np.int8,
           7: object, 9: np.int64, 10: np.bool_, 14: "bfloat16", 19: np.float16}
_DTYPE_NAMES = {1: "DT_FLOAT", 2: "DT_DOUBLE", 3: "DT_INT32", 4: "DT_UINT8", 5: "DT_INT16",
                6: "DT_INT8", 7: "DT_STRING", 9: "DT_INT64", 10: "DT_BOOL", 14: "DT_BFLOAT16",
                19: "DT_HALF"}
_WRITES = {np.dtype(v): k for k, v in _DTYPES.items() if k not in (7, 14)}
_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER = 48
_BLOCK_SIZE = 262144           # TF's table::Options: block size, restart interval
_RESTART_INTERVAL = 16
_HEADER = b"\x08\x01\x1a\x02\x08\x01"   # BundleHeaderProto{num_shards 1, version {producer 1}}


class _Entry:
    """A BundleEntryProto."""

    def __init__(self, value: bytes):
        self.dtype, self.shape, self.shard_id = 0, (), 0
        self.offset = self.size = self.crc32c = 0
        self.sliced = False
        for f, v in _fields(value):
            if f == 1:
                self.dtype = v
            elif f == 2:
                self.shape = tuple(_dim_size(d) for k, d in _fields(v) if k == 2)
            elif f == 3:
                self.shard_id = v
            elif f == 4:
                self.offset = v
            elif f == 5:
                self.size = v
            elif f == 6:
                self.crc32c = v
            elif f == 7:
                self.sliced = True


def _dim_size(dim: bytes) -> int:
    size = next((v for f, v in _fields(dim) if f == 1), 0)
    return size - (1 << 64) if size >= 1 << 63 else size


def _encode_entry(dtype: int, shape: tuple, offset: int, size: int, crc: int) -> bytes:
    dims = b"".join(_field(2, _field(1, d, 0) if d else b"", 2) for d in shape)
    out = _field(1, dtype, 0) + _field(2, dims, 2)
    if offset:
        out += _field(4, offset, 0)
    if size:
        out += _field(5, size, 0)
    return out + _field(6, crc, 5)


# ---- the LevelDB-format table of the .index file -----------------------------------

def _read_block(data: bytes, offset: int, size: int, path: str) -> bytes:
    if offset + size + 5 > len(data):
        raise ValueError(f"{path}: a table block runs past the end of the file")
    contents = data[offset:offset + size]
    kind = data[offset + size]
    stored = struct.unpack_from("<I", data, offset + size + 1)[0]
    if _mask(crc32c(bytes([kind]), crc32c(contents))) != stored:
        raise ValueError(f"{path}: CRC32C mismatch in the table block at offset {offset}")
    if kind != 0:
        raise ValueError(f"{path}: a compressed table block (type {kind}); TF's tensor "
                         "bundle writes them uncompressed")
    return contents


def _block_entries(block: bytes) -> list[tuple[bytes, bytes]]:
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * num_restarts
    out, pos, key = [], 0, b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        out.append((key, block[pos:pos + vlen]))
        pos += vlen
    return out


def _handle(buf: bytes, pos: int = 0) -> tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def _read_table(path: str) -> list[tuple[bytes, bytes]]:
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER or struct.unpack_from("<Q", data, len(data) - 8)[0] != _TABLE_MAGIC:
        raise ValueError(f"{path}: not a TF tensor-bundle index (no table magic)")
    footer = data[len(data) - _FOOTER:]
    _, _, pos = _handle(footer)
    index_off, index_size, _ = _handle(footer, pos)
    entries = []
    for _, handle in _block_entries(_read_block(data, index_off, index_size, path)):
        off, size, _ = _handle(handle)
        entries += _block_entries(_read_block(data, off, size, path))
    return entries


class _Block:
    """A LevelDB-format block being written: keys share a prefix with the
    previous key, with a full key (a restart point) every `interval` entries."""

    def __init__(self, interval: int):
        self.interval = interval
        self.buf, self.restarts, self.counter, self.last = bytearray(), [0], 0, b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < self.interval:
            while (shared < min(len(self.last), len(key))
                   and self.last[shared] == key[shared]):
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += _put_varint(shared) + _put_varint(len(key) - shared) + _put_varint(len(value))
        self.buf += key[shared:] + value
        self.last, self.counter = key, self.counter + 1

    def size_estimate(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        return (bytes(self.buf) + b"".join(struct.pack("<I", r) for r in self.restarts)
                + struct.pack("<I", len(self.restarts)))


def _shortest_separator(start: bytes, limit: bytes) -> bytes:
    """LevelDB's BytewiseComparator::FindShortestSeparator."""
    n = 0
    while n < min(len(start), len(limit)) and start[n] == limit[n]:
        n += 1
    if n < min(len(start), len(limit)):
        b = start[n]
        if b < 0xFF and b + 1 < limit[n]:
            return start[:n] + bytes([b + 1])
    return start


def _short_successor(key: bytes) -> bytes:
    """LevelDB's BytewiseComparator::FindShortSuccessor."""
    for i, b in enumerate(key):
        if b != 0xFF:
            return key[:i] + bytes([b + 1])
    return key


def _table(entries: list[tuple[bytes, bytes]]) -> bytes:
    """A LevelDB-format table of sorted (key, value) entries, as TF's table
    writer lays it out with the bundle's options: no compression, no filter,
    TF's block size and restart interval, index restart interval 1."""
    out = bytearray()

    def write(block: _Block) -> bytes:
        contents = block.finish()
        handle = _put_varint(len(out)) + _put_varint(len(contents))
        out.extend(contents + b"\x00"
                   + struct.pack("<I", _mask(crc32c(b"\x00", crc32c(contents)))))
        return handle

    data, index = _Block(_RESTART_INTERVAL), _Block(1)
    pending, last = None, b""
    for key, value in entries:
        if pending is not None:
            index.add(_shortest_separator(last, key), pending)
            pending = None
        last = key
        data.add(key, value)
        if data.size_estimate() >= _BLOCK_SIZE:
            pending, data = write(data), _Block(_RESTART_INTERVAL)
    if data.buf:
        pending = write(data)
    metaindex = write(_Block(_RESTART_INTERVAL))
    if pending is not None:
        index.add(_short_successor(last), pending)
    footer = metaindex + write(index)
    out += footer + b"\x00" * (_FOOTER - 8 - len(footer)) + struct.pack("<Q", _TABLE_MAGIC)
    return bytes(out)


# ---- reading ---------------------------------------------------------------------------

def _parse_text_string(s: str) -> str:
    """The value of a text-format string field (C escapes undone)."""
    raw = s.strip()
    if len(raw) < 2 or raw[0] != raw[-1] or raw[0] not in "\"'":
        raise ValueError(f"not a quoted string: {s!r}")
    return raw[1:-1].encode("latin-1").decode("unicode_escape").encode("latin-1").decode()


def _prefix_of(path: str) -> str:
    """A checkpoint prefix from a prefix or a directory whose `checkpoint` state
    file names one (relative names resolved against the directory), as
    tf.train.load_checkpoint takes its argument."""
    if not os.path.isdir(path):
        return path
    state = os.path.join(path, "checkpoint")
    if os.path.exists(state):
        with open(state) as f:
            for line in f:
                key, _, value = line.partition(":")
                if key.strip() == "model_checkpoint_path":
                    prefix = _parse_text_string(value)
                    return prefix if os.path.isabs(prefix) else os.path.join(path, prefix)
    raise ValueError(f"Couldn't find 'checkpoint' file or checkpoints in given directory {path}")


def _shard_name(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def _decode_strings(raw: bytes, count: int, entry: _Entry, name: str) -> np.ndarray:
    """A DT_STRING tensor's bytes: varint lengths, the masked CRC32C of the
    lengths (each as uint32 when it fits, else uint64), then the strings; the
    entry's CRC32C runs over the lengths, that checksum and the strings."""
    lengths, pos, crc = [], 0, 0
    for _ in range(count):
        n, pos = _varint(raw, pos)
        lengths.append(n)
        crc = crc32c(struct.pack("<I" if n <= 0xFFFFFFFF else "<Q", n), crc)
    stored = raw[pos:pos + 4]
    if struct.unpack("<I", stored)[0] != _mask(crc):
        raise ValueError(f"CRC32C mismatch in the string lengths of '{name}'")
    crc = crc32c(stored, crc)
    pos += 4
    out = np.empty(count, dtype=object)
    for i, n in enumerate(lengths):
        out[i] = raw[pos:pos + n]
        crc = crc32c(out[i], crc)
        pos += n
    if _mask(crc) != entry.crc32c:
        raise ValueError(f"CRC32C mismatch in the data of '{name}'")
    return out


def _v1_error(prefix: str) -> None:
    if os.path.isfile(prefix):
        with open(prefix, "rb") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() >= _FOOTER:
                f.seek(-8, os.SEEK_END)
                if struct.unpack("<Q", f.read(8))[0] == _TABLE_MAGIC:
                    raise ValueError(
                        f"{prefix} is a tf.train.Saver V1 checkpoint (one table file of "
                        "SavedTensorSlices, no .index): this reader takes only the V2 tensor "
                        "bundle; re-save it as V2 with TensorFlow (tf.train.Saver, "
                        "write_version=tf.train.SaverDef.V2)")


def read_tf_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a TF V2 checkpoint (tf.train.Saver or tf.train.Checkpoint)
    by its TF name: `path` is a prefix, or a directory whose `checkpoint` state
    file names one. Values as tf.train.load_checkpoint gives them (a DT_STRING
    tensor as an object array of bytes, a scalar one as bytes), except
    DT_BFLOAT16, read as float32. Every CRC32C is checked."""
    prefix = _prefix_of(path)
    index = prefix + ".index"
    if not os.path.exists(index):
        _v1_error(prefix)
        raise FileNotFoundError(f"no TF checkpoint at {prefix} (no {index})")
    entries = _read_table(index)
    if not entries or entries[0][0] != b"":
        raise ValueError(f"{index}: no BundleHeaderProto under the empty key")
    header = dict(_fields(entries[0][1]))
    num_shards = header.get(1, 0)
    if header.get(2, 0) != 0:
        raise ValueError(f"{index}: a big-endian tensor bundle; this reader takes little-endian")
    entries = [(key, _Entry(value)) for key, value in entries[1:]]
    for key, e in entries:
        if e.sliced:
            raise ValueError(f"'{key.decode(errors='replace')}' in {index} is a partitioned "
                             "(sliced) variable; this reader takes only whole tensors of a TF "
                             "V2 tensor bundle")
    files: dict[int, bytes] = {}
    out: dict[str, np.ndarray] = {}
    for key, e in entries:
        if key.startswith(b"\x00"):   # a slice's own entry (TF's encoded slice key)
            continue
        name = key.decode()
        if e.dtype not in _DTYPES:
            raise ValueError(f"'{name}' in {index} has TF DataType {e.dtype}, which this reader "
                             f"of the TF V2 tensor bundle does not take (it takes "
                             f"{', '.join(_DTYPE_NAMES.values())})")
        if e.shard_id not in files:
            with open(_shard_name(prefix, e.shard_id, num_shards), "rb") as f:
                files[e.shard_id] = f.read()
        raw = files[e.shard_id][e.offset:e.offset + e.size]
        if len(raw) != e.size:
            raise ValueError(f"'{name}' runs past the end of its data file")
        if e.dtype == 7:
            arr = _decode_strings(raw, int(np.prod(e.shape, dtype=np.int64)), e, name)
            out[name] = arr[0] if e.shape == () else arr.reshape(e.shape)
            continue
        if _mask(crc32c(raw)) != e.crc32c:
            raise ValueError(f"CRC32C mismatch in the data of '{name}'")
        if e.dtype == 14:   # bfloat16: the upper half of a float32
            arr = (np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(_DTYPES[e.dtype]).newbyteorder("<"))
        out[name] = arr.astype(np.float32 if e.dtype == 14 else _DTYPES[e.dtype]).reshape(e.shape)
    return out


# ---- writing ---------------------------------------------------------------------------

def _text_string(s: str) -> str:
    """A text-format string literal (C escapes, as protobuf's CEscape)."""
    out = []
    for b in s.encode():
        c = chr(b)
        if c in "\\\"'":
            out.append("\\" + c)
        elif c == "\n":
            out.append("\\n")
        elif c == "\r":
            out.append("\\r")
        elif c == "\t":
            out.append("\\t")
        elif 0x20 <= b < 0x7F:
            out.append(c)
        else:
            out.append(f"\\{b:03o}")
    return '"' + "".join(out) + '"'


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def write_tf_checkpoint(tensors: dict[str, np.ndarray], path: str) -> str:
    """Write `tensors` (numeric numpy arrays) as a single-shard TF V2 checkpoint
    at prefix `path`: the data file holds them in name order, as tf.train.Saver
    adds them, and the index maps each name to its entry. Returns `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = bytearray()
    entries = [(b"", _HEADER)]
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if arr.dtype not in _WRITES:
            raise ValueError(f"'{name}': cannot write dtype {arr.dtype} to a TF checkpoint")
        raw = np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes()
        entries.append((name.encode(), _encode_entry(_WRITES[arr.dtype], arr.shape, len(data),
                                                     len(raw), _mask(crc32c(raw)))))
        data += raw
    entries.sort(key=lambda kv: kv[0])
    _atomic_write(_shard_name(path, 0, 1), bytes(data))
    _atomic_write(path + ".index", _table(entries))
    return path


def write_checkpoint_state(path: str) -> None:
    """The `checkpoint` state file tf.train.Saver.save writes beside a
    checkpoint: its prefix as the latest and only one (as given)."""
    text = (f"model_checkpoint_path: {_text_string(path)}\n"
            f"all_model_checkpoint_paths: {_text_string(path)}\n")
    _atomic_write(os.path.join(os.path.dirname(path), "checkpoint"), text.encode())


# ---- the mapping layer ----------------------------------------------------------------

def _tree_paths(tree, prefix: str = "") -> dict[str, object]:
    """Flatten nested mappings to 'a/b/c' → leaf; LSTMParams stay whole leaves."""
    out: dict[str, object] = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_tree_paths(v, p + "/"))
        else:
            out[p] = v
    return out


def _unfold_keras(kernel, recurrent, bias, forget_bias: float):
    """Keras (i,f,c,o) kernel/recurrent/bias → LSTMParams in our (i,j,f,o)
    order with the folded forget bias removed."""
    h = recurrent.shape[0]

    def unreorder(w):
        i, f, c, o = np.split(np.asarray(w), 4, axis=-1)
        return np.concatenate([i, c, f, o], axis=-1)

    # remove the fold at the KERAS position (f is the 2nd block there), THEN
    # reorder the blocks into our (i, j, f, o) layout
    bias = np.asarray(bias).copy()
    bias[h:2 * h] -= forget_bias
    return LSTMParams(wx=unreorder(kernel), wh=unreorder(recurrent),
                      b=unreorder(bias[None, :])[0])


def _is_lstm(leaf) -> bool:
    return isinstance(leaf, LSTMParams) or (hasattr(leaf, "_fields")
                                            and "wx" in getattr(leaf, "_fields", ()))


def convert_params(abstract: dict, tfvars: dict[str, np.ndarray], mapping: dict,
                   forget_bias: float = 1.0) -> tuple[dict, dict]:
    """Map TF variables onto a params["params"]-shaped tree.

    abstract: the freshly initialized flax-shaped tree (the shape source; see
    convert.flax_tree_from_state_dict). Returns (new tree, report). Raises
    ValueError listing EVERY missing name / shape mismatch at once, so one
    --list round trip fixes the whole map."""
    flat = _tree_paths(abstract)
    errors: list[str] = []
    report = {"imported": 0, "kept_init": 0}
    new_flat: dict[str, object] = {}

    def fetch(name, want_shape, where):
        if name not in tfvars:
            errors.append(f"{where}: checkpoint has no variable '{name}'")
            return None
        arr = np.asarray(tfvars[name], np.float32)
        if tuple(arr.shape) != tuple(want_shape):
            errors.append(f"{where}: '{name}' has shape {tuple(arr.shape)}, "
                          f"model needs {tuple(want_shape)}")
            return None
        return arr

    for path, leaf in flat.items():
        if _is_lstm(leaf):
            spec = mapping.get(path)
            if spec is None:
                if path in mapping:  # explicit null: keep initialized values
                    report["kept_init"] += 1
                    new_flat[path] = leaf
                else:
                    errors.append(f"{path}: no mapping entry")
                continue
            d_in = leaf.wx.shape[0]
            h = leaf.wh.shape[0]
            if spec.get("layout", "tf1") == "keras":
                k = fetch(spec["kernel"], (d_in, 4 * h), path)
                r = fetch(spec["recurrent"], (h, 4 * h), path)
                b = fetch(spec["bias"], (4 * h,), path)
                if k is not None and r is not None and b is not None:
                    new_flat[path] = _unfold_keras(k, r, b, forget_bias)
                    report["imported"] += 1
            else:  # tf1 fused [D+H, 4H] kernel, gates already (i, j, f, o)
                k = fetch(spec["kernel"], (d_in + h, 4 * h), path)
                b = fetch(spec["bias"], (4 * h,), path)
                if k is not None and b is not None:
                    new_flat[path] = LSTMParams(wx=k[:d_in], wh=k[d_in:], b=b)
                    report["imported"] += 1
        else:
            name = mapping.get(path)
            if name is None:
                if path in mapping:
                    report["kept_init"] += 1
                    new_flat[path] = leaf
                else:
                    errors.append(f"{path}: no mapping entry")
                continue
            arr = fetch(name, np.shape(leaf), path)
            if arr is not None:
                new_flat[path] = arr
                report["imported"] += 1

    if errors:
        raise ValueError("TF checkpoint import failed:\n  " + "\n  ".join(errors))

    def rebuild(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            p = f"{prefix}{k}"
            out[k] = rebuild(v, p + "/") if isinstance(v, Mapping) else new_flat[p]
        return out

    return rebuild(abstract), report


def export_tf1_checkpoint(params: dict, path: str, prefix: str = "model",
                          mapping: dict | None = None) -> str:
    """Write a flax-shaped params["params"] tree of numpy arrays (see
    convert.flax_tree_from_state_dict) as a TF1-layout Saver checkpoint (fused
    LSTM kernels, (i,j,f,o) gates, in-cell forget bias → bias unchanged) at
    prefix `path`, with the `checkpoint` state file; no `.meta` graph (it needs
    TensorFlow to build). The inverse of convert_params for layout 'tf1'.
    Returns `path`, the prefix asked for."""
    mapping = mapping or default_tf1_map(prefix)
    tensors: dict[str, np.ndarray] = {}
    for leaf_path, leaf in _tree_paths(params).items():
        spec = mapping.get(leaf_path)
        if spec is None:
            continue
        if isinstance(spec, dict):
            tensors[spec["kernel"]] = np.concatenate(
                [np.asarray(leaf.wx), np.asarray(leaf.wh)], axis=0)
            tensors[spec["bias"]] = np.asarray(leaf.b)
        else:
            tensors[spec] = np.asarray(leaf)
    write_tf_checkpoint(tensors, path)
    write_checkpoint_state(path)
    return path
