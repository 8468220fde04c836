"""The port's TF checkpoint import and export (fvta_memexqa_torch/tf_import.py,
which reads and writes the TF V2 tensor bundle without TensorFlow) against
TensorFlow's own reader and Saver and against the JAX package's tf_import:

- the reader on checkpoints TF writes (the JAX export, which is TF's Saver;
  tf.train.Checkpoint with strings; every dtype it reads; a directory; two
  shards) gives TF's names, dtypes, shapes and bits (bfloat16 as float32);
- the writer's .index and data file are byte for byte the Saver's (also past
  one index block), TF reads them back bitwise, and so does the JAX
  convert_params;
- V1 checkpoints, sliced variables and a broken CRC32C are refused;
- convert_params and the flax tree of the port's state_dict as in JAX;
- the CLI flow of tests/test_tf_import.py with the port's CLI.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import torch  # noqa: E402

from fvta_memexqa_tpu import cli as j_cli  # noqa: E402
from fvta_memexqa_tpu import tf_import as j_tf  # noqa: E402
from fvta_memexqa_tpu.data import Dataset, SharedTables, assemble  # noqa: E402
from fvta_memexqa_tpu.data.device_prepro import device_put_batch  # noqa: E402
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel  # noqa: E402
from fvta_memexqa_tpu.train import test as j_run_test  # noqa: E402

from fvta_memexqa_torch import cli  # noqa: E402
from fvta_memexqa_torch import tf_import as ti  # noqa: E402
from fvta_memexqa_torch.config import Config  # noqa: E402
from fvta_memexqa_torch.convert import (flax_tree_from_state_dict,  # noqa: E402
                                        state_dict_from_flax)
from fvta_memexqa_torch.models import FVTAModel  # noqa: E402

WIDTHS = ["--hidden-dim", "16", "--char-emb-dim", "8", "--char-cnn-filters", "16"]


@pytest.fixture(scope="module")
def jparams(packed_synth, small_config):
    """The JAX model's params["params"] at small_config, as numpy arrays."""
    shared = SharedTables.from_packed(packed_synth.shared)
    batch = device_put_batch(next(iter(Dataset(packed_synth, "train").get_batches(4))))
    model = JFVTAModel(cfg=small_config)
    params = jax.jit(lambda k: model.init(k, shared, assemble(shared, batch), train=False))(
        jax.random.key(7))
    return jax.tree.map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def tf_export(jparams, tmp_path_factory):
    """The JAX package's export of jparams: tf.train.Saver's checkpoint."""
    return j_tf.export_tf1_checkpoint(jparams, str(tmp_path_factory.mktemp("jexp") / "ck"))


def tf_tensors(prefix) -> dict:
    reader = tf.train.load_checkpoint(prefix)
    return {name: reader.get_tensor(name) for name in reader.get_variable_to_shape_map()}


def assert_same_tensors(mine: dict, theirs: dict, bf16_as_f32: bool = False) -> None:
    assert sorted(mine) == sorted(theirs)
    for name, want in theirs.items():
        got = mine[name]
        if isinstance(want, bytes):
            assert isinstance(got, bytes) and got == want, name
            continue
        if bf16_as_f32 and want.dtype == tf.bfloat16.as_numpy_dtype:
            want = want.astype(np.float32)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if want.dtype == object:
            assert list(got.ravel()) == list(want.ravel()), name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


def assert_same_tree(a: dict, b: dict) -> None:
    """Same leaf paths in the same order, every array (each LSTMParams field)
    bitwise equal with the same dtype."""
    fa, fb = j_tf._tree_paths(a), j_tf._tree_paths(b)
    assert list(fa) == list(fb)
    for path in fa:
        xs, ys = ((v,) if hasattr(v, "shape") else tuple(v) for v in (fa[path], fb[path]))
        for x, y in zip(xs, ys):
            assert np.asarray(x).dtype == np.asarray(y).dtype, path
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=path)


def save_with_saver(tensors: dict, prefix: str, **saver_kw) -> str:
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    graph = tf.Graph()
    with graph.as_default():
        tfvars = {name: tf.Variable(val) for name, val in tensors.items()}
        saver = tf.compat.v1.train.Saver(var_list=tfvars, **saver_kw)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            return saver.save(sess, prefix)


# ---- the flax tree of the port's parameters ---------------------------------------------

def test_flax_tree_round_trips_bitwise(jparams, small_config):
    assert_same_tree(flax_tree_from_state_dict(state_dict_from_flax(jparams)), jparams)
    cfg = Config.from_json(small_config.to_json())
    sd = FVTAModel(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    back = state_dict_from_flax(flax_tree_from_state_dict(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


# ---- the reader -------------------------------------------------------------------------------

def test_reader_reads_the_saver_checkpoint_as_tf_does(tf_export):
    assert_same_tensors(ti.read_tf_checkpoint(tf_export), tf_tensors(tf_export))


def test_reader_takes_a_directory_and_two_shards(tmp_path):
    graph = tf.Graph()
    with graph.as_default():
        with tf.device("/cpu:0"):
            a = tf.Variable(np.arange(6, dtype=np.float32).reshape(2, 3), name="a")
        with tf.device("/cpu:1"):
            b = tf.Variable(np.arange(4, dtype=np.int64), name="b")
        saver = tf.compat.v1.train.Saver(var_list={"s/a": a, "s/b": b}, sharded=True)
        config = tf.compat.v1.ConfigProto(device_count={"CPU": 2})
        with tf.compat.v1.Session(config=config) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "ck"))
    assert os.path.exists(prefix + ".data-00001-of-00002")
    assert_same_tensors(ti.read_tf_checkpoint(str(tmp_path)), tf_tensors(prefix))


def test_reader_takes_every_dtype_tf_writes(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"f32": rng.normal(size=(3, 4)).astype(np.float32),
               "f64": rng.normal(size=(2,)),
               "f16": rng.normal(size=(5,)).astype(np.float16),
               "bf16": rng.normal(size=(2, 3)).astype(tf.bfloat16.as_numpy_dtype),
               "i8": np.array([-128, 0, 127], np.int8), "u8": np.array([0, 255], np.uint8),
               "i16": np.array([-32768, 7], np.int16), "i32": np.int32(-7),
               "i64": np.array([-(2 ** 62), 2 ** 40], np.int64),
               "bool": np.array([[True, False]]), "empty": np.zeros((0, 3), np.float32)}
    prefix = save_with_saver(tensors, str(tmp_path / "saver" / "ck"))
    assert_same_tensors(ti.read_tf_checkpoint(prefix), tf_tensors(prefix), bf16_as_f32=True)
    ck = tf.train.Checkpoint(s=tf.Variable(b"hello"), v=tf.Variable([b"a", b"", b"xyz" * 60]),
                             w=tf.Variable(np.ones((2, 2), np.float32)))
    prefix = ck.write(str(tmp_path / "obj" / "ck"))
    assert_same_tensors(ti.read_tf_checkpoint(prefix), tf_tensors(prefix))


def test_reader_refuses_saver_v1(tmp_path):
    prefix = save_with_saver({"v": np.ones(3, np.float32)}, str(tmp_path / "v1" / "ck"),
                             write_version=tf.compat.v1.train.SaverDef.V1)
    assert not os.path.exists(prefix + ".index")
    with pytest.raises(ValueError, match="Saver V1"):
        ti.read_tf_checkpoint(prefix)


def test_reader_refuses_a_sliced_variable(tmp_path):
    graph = tf.Graph()
    with graph.as_default():
        tf.compat.v1.get_variable("w", shape=[8, 3],
                                  partitioner=tf.compat.v1.fixed_size_partitioner(2))
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="partitioned"):
        ti.read_tf_checkpoint(prefix)


@pytest.mark.parametrize("suffix", [".index", ".data-00000-of-00001"])
def test_reader_checks_every_crc32c(tf_export, tmp_path, suffix):
    prefix = str(tmp_path / "ck")
    for s in (".index", ".data-00000-of-00001"):
        data = bytearray(open(tf_export + s, "rb").read())
        if s == suffix:
            data[20] ^= 0x10   # inside the first data block / the first tensor
        open(prefix + s, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC32C"):
        ti.read_tf_checkpoint(prefix)


# ---- the writer -------------------------------------------------------------------------------

def test_writer_is_the_savers_bytes_and_reads_back(jparams, tf_export, tmp_path):
    prefix = str(tmp_path / "mine" / "ck")
    tree = flax_tree_from_state_dict(state_dict_from_flax(jparams))
    assert ti.export_tf1_checkpoint(tree, prefix) == prefix
    for suffix in (".index", ".data-00000-of-00001"):
        with open(prefix + suffix, "rb") as a, open(tf_export + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    with open(os.path.join(os.path.dirname(prefix), "checkpoint")) as a, \
            open(os.path.join(os.path.dirname(tf_export), "checkpoint")) as b:
        assert a.read() == b.read().replace(tf_export, prefix)
    assert not os.path.exists(prefix + ".meta")
    tfvars = tf_tensors(prefix)
    assert_same_tensors(tfvars, tf_tensors(tf_export))
    new, report = j_tf.convert_params(jparams, tfvars, j_tf.default_tf1_map())
    assert report == {"imported": 33, "kept_init": 0}
    assert_same_tree(new, jparams)


def test_writer_spans_several_index_blocks_as_saver_does(tmp_path):
    """Past TF's 256 KiB table block the index holds several data blocks, each
    with its separator key in the index block: still the Saver's bytes."""
    tensors = {f"model/scope_{i:05d}/{'x' * 300}/kernel": np.float32([i, -i])
               for i in range(900)}
    theirs = save_with_saver(tensors, str(tmp_path / "tf" / "ck"))
    mine = ti.write_tf_checkpoint(tensors, str(tmp_path / "mine" / "ck"))
    assert os.path.getsize(mine + ".index") > ti._BLOCK_SIZE
    for suffix in (".index", ".data-00000-of-00001"):
        with open(mine + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert_same_tensors(ti.read_tf_checkpoint(mine), tf_tensors(theirs))


# ---- the mapping layer ------------------------------------------------------------------------

def keras_case(jparams):
    p = jparams["enc_word"]["fw"]
    h = p.wh.shape[0]

    def reorder(w):   # ours (i, j, f, o) -> keras (i, f, c, o)
        i, j, f, o = np.split(np.asarray(w), 4, axis=-1)
        return np.concatenate([i, f, j, o], axis=-1)

    bias = reorder(p.b[None, :])[0].copy()
    bias[h:2 * h] += 1.0
    tfvars = {"k/kernel": reorder(p.wx), "k/recurrent": reorder(p.wh), "k/bias": bias}
    mapping = {"enc": {"kernel": "k/kernel", "recurrent": "k/recurrent", "bias": "k/bias",
                       "layout": "keras"}}
    return {"enc": type(p)(np.zeros_like(p.wx), np.zeros_like(p.wh), np.zeros_like(p.b))}, \
        tfvars, mapping


@pytest.mark.parametrize("layout", ["tf1", "keras", "null"])
def test_convert_params_as_jax(jparams, tf_export, layout):
    if layout == "keras":
        abstract, tfvars, mapping = keras_case(jparams)
    else:
        abstract, tfvars, mapping = jparams, ti.read_tf_checkpoint(tf_export), ti.default_tf1_map()
        if layout == "null":
            mapping["highway/h0/kernel"] = None
            mapping["enc_when/bw"] = None
    assert ti.default_tf1_map("m") == j_tf.default_tf1_map("m")
    got, got_report = ti.convert_params(abstract, tfvars, mapping, forget_bias=1.0)
    want, want_report = j_tf.convert_params(abstract, tfvars, mapping, forget_bias=1.0)
    assert got_report == want_report
    assert_same_tree(got, want)


def test_convert_params_error_text_as_jax(jparams, tf_export):
    tfvars = ti.read_tf_checkpoint(tf_export)
    del tfvars["model/scorer/kernel"]
    tfvars["model/sim_w_x"] = np.zeros(3, np.float32)
    tfvars["model/enc_word/bidirectional_rnn/fw/basic_lstm_cell/bias"] = np.zeros(5, np.float32)
    mapping = ti.default_tf1_map()
    del mapping["char_cnn/char_emb"]
    errors = []
    for convert in (ti.convert_params, j_tf.convert_params):
        with pytest.raises(ValueError) as e:
            convert(flax_tree_from_state_dict(state_dict_from_flax(jparams)), tfvars, mapping)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].count("\n") == 4


# ---- the CLI ----------------------------------------------------------------------------------

def run(main, argv) -> tuple[object, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    return rc, out.getvalue()


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_cli_import_test_export_reimport(pack_dir, packed_synth, small_config, tf_export,
                                         tmp_path):
    """import-tf-checkpoint then `cli test` on the port's CLI gives the JAX CLI's
    import then JAX `test`'s loss; export and re-import give the same loss
    exactly, and the export is the Saver's bytes."""
    j_run = str(tmp_path / "jrun")
    run(j_cli.main, ["import-tf-checkpoint", tf_export, pack_dir, j_run, *WIDTHS])
    ref = j_run_test(small_config, packed_synth, j_run, load_best=True, split="test",
                     echo=False)

    p_run = str(tmp_path / "prun")
    rc, out = run(cli.main, ["import-tf-checkpoint", tf_export, pack_dir, p_run, *WIDTHS,
                             "--device", "cpu"])
    assert rc == 0
    assert last_json(out) == {"rundir": p_run, "imported": 33, "kept_init": 0,
                              "tf_variables": 47}
    first = last_json(run(cli.main, ["test", pack_dir, p_run, "--device", "cpu"])[1])
    assert first["count"] == ref["count"] > 0 and first["accuracy"] == ref["acc"]
    assert first["loss"] == pytest.approx(ref["loss"], rel=1e-5)

    exported = str(tmp_path / "tfexp" / "ck")
    rc, out = run(cli.main, ["export-tf-checkpoint", pack_dir, p_run, exported,
                             "--load-latest"])
    assert rc == 0 and last_json(out) == {"tf_checkpoint": exported, "step": 0,
                                          "from": "latest"}
    for suffix in (".index", ".data-00000-of-00001"):
        with open(exported + suffix, "rb") as a, open(tf_export + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    p_run2 = str(tmp_path / "prun2")
    run(cli.main, ["import-tf-checkpoint", exported, pack_dir, p_run2, *WIDTHS,
                   "--device", "cpu"])
    again = last_json(run(cli.main, ["test", pack_dir, p_run2, "--device", "cpu"])[1])
    assert again == first


def test_cli_list_and_dump_map_as_jax(pack_dir, tf_export, tmp_path):
    outs = [run(main, ["import-tf-checkpoint", tf_export, pack_dir, str(tmp_path / "r"),
                       "--list"])[1] for main in (cli.main, j_cli.main)]
    assert outs[0] == outs[1] and outs[0].count("\n") == 47
    dumps = []
    for k, main in enumerate((cli.main, j_cli.main)):
        path = str(tmp_path / f"map{k}.json")
        rc, out = run(main, ["import-tf-checkpoint", tf_export, pack_dir, str(tmp_path / "r"),
                             "--dump-map", path, "--tf-prefix", "net"])
        assert last_json(out) == {"dumped": path}
        with open(path, "rb") as f:
            dumps.append(f.read())
    assert dumps[0] == dumps[1]
