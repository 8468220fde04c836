"""Port data layer vs the JAX package's: synthetic corpus, tokenizer, pack format
(array for array, both directions), device-side assembly; and the port's import
boundary (no JAX, nothing of fvta_memexqa_tpu)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.data import Dataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import assemble as j_assemble
from fvta_memexqa_tpu.data import load_pack as j_load_pack
from fvta_memexqa_tpu.data import make_synthetic as j_make_synthetic
from fvta_memexqa_tpu.data.device_prepro import assemble_albums as j_assemble_albums
from fvta_memexqa_tpu.data.tokenize import tokenize as j_tokenize

from fvta_memexqa_torch.data import (Batch, SharedTables, assemble, assemble_albums,
                                     load_pack, make_synthetic, pack, tokenize)
from tests.conftest import small_data_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def torch_pack_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_pack"))
    qas, albums, feats, test_ids, glove = make_synthetic(seed=0)
    pack(qas, albums, feats, test_ids, glove, out, small_data_config(), seed=0)
    return out


def test_make_synthetic_matches_jax():
    a = make_synthetic(seed=3, num_albums=5, num_questions=20)
    b = j_make_synthetic(seed=3, num_albums=5, num_questions=20)
    assert [q.__dict__ for q in a[0]] == [q.__dict__ for q in b[0]]
    assert {k: v.__dict__ for k, v in a[1].items()} == {k: v.__dict__ for k, v in b[1].items()}
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        np.testing.assert_array_equal(a[2][k], b[2][k])
    assert a[3] == b[3]
    assert a[4].keys() == b[4].keys()


@pytest.mark.parametrize("text", ["What year was the trip?", "don't STOP -- 2013!",
                                  "café  crème, naïve", ""])
def test_tokenize_matches_jax(text):
    assert tokenize(text) == j_tokenize(text)


def test_pack_matches_jax_array_for_array(torch_pack_dir, pack_dir):
    mine, ref = load_pack(torch_pack_dir), j_load_pack(pack_dir)
    assert mine.cfg.__dict__ == ref.cfg.__dict__
    for k, v in ref.shared.__dict__.items():
        np.testing.assert_array_equal(getattr(mine.shared, k), v, err_msg=k)
    assert mine.splits.keys() == ref.splits.keys()
    for split, arrays in ref.splits.items():
        assert mine.splits[split].keys() == arrays.keys()
        for k, v in arrays.items():
            np.testing.assert_array_equal(mine.splits[split][k], v, err_msg=f"{split}.{k}")
    with open(os.path.join(torch_pack_dir, "meta.json")) as f1, \
            open(os.path.join(pack_dir, "meta.json")) as f2:
        assert json.load(f1) == json.load(f2)


def test_load_pack_reads_jax_pack(pack_dir):
    mine, ref = load_pack(pack_dir), j_load_pack(pack_dir)
    assert mine.meta == ref.meta
    for k, v in ref.shared.__dict__.items():
        np.testing.assert_array_equal(getattr(mine.shared, k), v, err_msg=k)


def test_assemble_matches_jax(packed_synth):
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    jb = next(iter(Dataset(packed_synth, "train").get_batches(4)))
    batch = Batch.from_split(packed_synth.splits["train"], np.arange(4), "cpu")
    ref, mine = j_assemble(j_shared, jb), assemble(shared, batch)
    for name in ref.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(mine, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    ids = np.asarray([1, 0, 3], np.int32)
    ref = j_assemble_albums(packed_synth.cfg, j_shared, ids)
    mine = assemble_albums(packed_synth.cfg, shared, torch.from_numpy(ids))
    for name in ref.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(mine, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fvta_memexqa_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'fvta_memexqa_tpu'))\n"
        "assert not bad, bad\n"
        "need = {'fvta_memexqa_torch.ops.lstm_grouped', 'fvta_memexqa_torch.eval_cache',\n"
        "        'fvta_memexqa_torch.data.categories', 'fvta_memexqa_torch.parallel.cp'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print('ok', len([n for n in sys.modules if n.startswith('fvta_memexqa_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
    # every module was imported: the video slice's and the grouped scans' and
    # categories' included
    assert int(res.stdout.split()[1]) >= 36
