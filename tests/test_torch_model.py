"""Port FVTAModel vs the JAX package's FVTAModel.apply with the same weights
(carried across by convert.py) at small_config: encode_context, answer and the
full forward — logits, time_attn and seq_attn at 1e-5. Also the embedding
goldens, the vocab-table and photo-table fast paths, and the run directory."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from fvta_memexqa_tpu.data import Dataset
from fvta_memexqa_tpu.data import SharedTables as JSharedTables
from fvta_memexqa_tpu.data import assemble as j_assemble
from fvta_memexqa_tpu.data.device_prepro import device_put_batch
from fvta_memexqa_tpu.models import FVTAModel as JFVTAModel

from fvta_memexqa_torch.config import Config
from fvta_memexqa_torch.convert import load_rundir, model_from_flax, save_rundir
from fvta_memexqa_torch.data import Batch, SharedTables, assemble
from fvta_memexqa_torch.models import CharCNN, FVTAModel, make_photo_table
from fvta_memexqa_torch.models.fvta import a1_config
from fvta_memexqa_torch.serve import resolve_device

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOL = dict(rtol=1e-5, atol=1e-5)


def port_config(cfg) -> Config:
    """The JAX Config as the port's Config (same JSON)."""
    return Config.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def pair(packed_synth, small_config):
    """(jax model, flax params, jax inputs, port model, port shared, port inputs)."""
    j_shared = JSharedTables.from_packed(packed_synth.shared)
    jb = device_put_batch(next(iter(Dataset(packed_synth, "train").get_batches(4))))
    j_mi = j_assemble(j_shared, jb)
    j_model = JFVTAModel(cfg=small_config)
    params = jax.jit(lambda k: j_model.init(k, j_shared, j_mi, train=False))(
        jax.random.key(0))
    model = model_from_flax(port_config(small_config), jax.tree.map(np.asarray, params))
    shared = SharedTables.from_packed(packed_synth.shared, "cpu")
    mi = assemble(shared, Batch.from_split(packed_synth.splits["train"], np.arange(4), "cpu"))
    return j_model, params, j_shared, j_mi, model, shared, mi


def test_char_cnn_golden():
    g = np.load(os.path.join(GOLDEN, "char_cnn.npz"))
    cnn = CharCNN(char_vocab_size=20, emb_dim=6, num_filters=8, width=3)
    cnn.load_state_dict({"char_emb": torch.from_numpy(g["p_0"]),
                         "conv_bias": torch.from_numpy(g["p_1"]),
                         "conv_kernel": torch.from_numpy(g["p_2"])})
    with torch.no_grad():
        out = cnn(torch.from_numpy(g["chars"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-5, atol=1e-6)


def test_full_forward_matches_jax_and_golden(pair):
    j_model, params, j_shared, j_mi, model, shared, mi = pair
    ref = j_model.apply(params, j_shared, j_mi, train=False)
    with torch.no_grad():
        out = model(shared, mi)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), **TOL)
    np.testing.assert_allclose(out.attention.time_attn.numpy(),
                               np.asarray(ref.attention.time_attn), **TOL)
    np.testing.assert_allclose(out.attention.seq_attn.numpy(),
                               np.asarray(ref.attention.seq_attn), **TOL)
    g = np.load(os.path.join(GOLDEN, "model_forward.npz"))
    np.testing.assert_allclose(out.logits.numpy(), g["logits"], **TOL)
    np.testing.assert_allclose(out.attention.seq_attn.numpy(), g["seq_attn"], **TOL)


def test_encode_context_and_answer_match_jax(pair):
    j_model, params, j_shared, j_mi, model, shared, mi = pair
    jh, jm = j_model.apply(params, j_shared, j_mi, train=False,
                           method=j_model.encode_context)
    ref = j_model.apply(params, j_shared, j_mi, jh, jm, train=False, method=j_model.answer)
    with torch.no_grad():
        h, m = model.encode_context(shared, mi)
        out = model.answer(shared, mi, h, m)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), **TOL)
    for f in ("context", "question", "time_attn", "seq_attn"):
        np.testing.assert_allclose(getattr(out.attention, f).numpy(),
                                   np.asarray(getattr(ref.attention, f)), **TOL, err_msg=f)


def test_vocab_table_path_equals_per_token_path(pair, small_config):
    *_, model, shared, mi = pair
    cfg = port_config(small_config)
    per_token = FVTAModel(cfg.replace(model=dataclasses.replace(cfg.model,
                                                                vocab_embed=False)))
    per_token.load_state_dict(model.state_dict())
    with torch.no_grad():
        a, b = model(shared, mi), per_token.eval()(shared, mi)
    np.testing.assert_allclose(a.logits.numpy(), b.logits.numpy(), rtol=1e-6, atol=1e-6)


def test_photo_table_path_equals_raw_path(pair, packed_synth):
    *_, model, shared, mi = pair
    batch = Batch.from_split(packed_synth.splits["train"], np.arange(4), "cpu")
    mi_pt = assemble(shared, batch, photo_table=make_photo_table(model, shared))
    assert mi_pt.photo_projected
    with torch.no_grad():
        a, b = model(shared, mi), model(shared, mi_pt)
    np.testing.assert_allclose(a.logits.numpy(), b.logits.numpy(), rtol=1e-6, atol=1e-6)


def test_a1_encode_matches_batch_encode(pair, packed_synth):
    """One album per row (the serving cache's encode) reproduces the per-question
    context of that album."""
    from fvta_memexqa_torch.data import assemble_albums

    *_, model, shared, mi = pair
    rows = mi.album_mask[:, 0].nonzero()[:, 0]
    ids = Batch.from_split(packed_synth.splits["train"], np.arange(4), "cpu").album_idx[rows, 0]
    with torch.no_grad():
        h_all, m_all = model.encode_context(shared, mi)
        h_u, m_u = model.encode_context(
            shared, assemble_albums(a1_config(model.cfg).data, shared, ids))
    np.testing.assert_allclose(h_u.numpy(), h_all[rows, :6].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(m_u.numpy(), m_all[rows, :6].numpy())


def test_rundir_roundtrip(pair, tmp_path):
    *_, model, shared, mi = pair
    save_rundir(str(tmp_path), model.cfg, model)
    cfg, loaded = load_rundir(str(tmp_path), "cpu")
    assert cfg == model.cfg
    with torch.no_grad():
        a, b = model(shared, mi), loaded(shared, mi)
    np.testing.assert_array_equal(a.logits.numpy(), b.logits.numpy())


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
