"""Train and eval steps and the training loop (the JAX package's train.py).

One step: assemble the batch on the device, forward (the bi-LSTM kernel K1 and
the FVTA kernel K2 on the card), masked 4-way cross-entropy, backward (the
bi-LSTM backward kernel K1b, K2's gradient by recompute), then the optax-style
optimizer of optim.py. The loop runs epochs over the train split in a
(seed, epoch)-determined order, logs JSONL metrics, validates every
val_period steps, keeps the latest and the best checkpoints, stops at
num_steps, and resumes a killed run mid-epoch at step mod batches-per-epoch,
bit-identically: it turns on torch's deterministic algorithms for the run
(index backward and the dedup gather otherwise accumulate with atomics, on the
CPU as on the card).

Train-time album dedup (TrainConfig.dedup_albums) encodes each distinct album
of a batch once and gathers per-question context rows from the unique encodes
(eval_cache.gather_cached_context); at keep_prob = 1 it is the same function
of the parameters as the plain step.

Evaluation of a run directory (`cli test`): `test` restores the best or the
latest checkpoint and evaluates a split, through the album cache
(eval_cache.py) or with a full re-encode per question, optionally with the
per-category table and an attention dump (`dump_attention`); `test_ensemble`
averages several runs' choice probabilities.

Data parallelism (MeshConfig.num_devices > 1) is not ported yet and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from fvta_memexqa_torch.checkpoint import CheckpointManager
from fvta_memexqa_torch.config import Config, load_config
from fvta_memexqa_torch.convert import save_rundir
from fvta_memexqa_torch.data.device_prepro import Batch, SharedTables, assemble, assemble_albums
from fvta_memexqa_torch.data.pipeline import Dataset
from fvta_memexqa_torch.data.categories import accuracy_by_category, question_categories
from fvta_memexqa_torch.eval_cache import (SHARD_CACHE_NOT_PORTED, evaluate_cached,
                                           gather_cached_context, precompute_album_cache,
                                           predict_cached)
from fvta_memexqa_torch.models.fvta import (FVTAModel, a1_config, make_photo_table,
                                            make_vocab_table)
from fvta_memexqa_torch.optim import Optimizer
from fvta_memexqa_torch.serve import resolve_device
from fvta_memexqa_torch.utils.metrics import MetricsLogger, Timer


def debug_nans_enabled() -> bool:
    """FVTA_DEBUG_NANS=1 → torch.autograd anomaly detection for the run (the
    backward then names the forward op that produced a NaN); the loop also
    hard-fails on a non-finite loss at each log boundary."""
    return os.environ.get("FVTA_DEBUG_NANS", "") not in ("", "0", "false")


def check_finite_loss(loss: float, step: int) -> None:
    """Raise with context if the training loss went non-finite."""
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite training loss {loss!r} at step {step}; rerun with "
            "FVTA_DEBUG_NANS=1 to locate the producing op")


@dataclass
class TrainState:
    model: FVTAModel
    opt_state: dict
    step: int
    generator: torch.Generator   # dropout noise, on the model's device

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def init_state(cfg: Config, device, seed: int | None = None) -> TrainState:
    """Fresh model (weights from a CPU generator seeded with `seed`), optimizer
    state, step 0, and a dropout generator on `device` seeded with seed + 1."""
    seed = cfg.train.seed if seed is None else seed
    device = torch.device(device)
    model = FVTAModel(cfg, generator=torch.Generator().manual_seed(seed)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    opt_state = Optimizer(cfg.train).init(dict(model.named_parameters()))
    return TrainState(model=model, opt_state=opt_state, step=0, generator=gen)


def masked_choice_metrics(logits: torch.Tensor, label: torch.Tensor,
                          ex_mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Masked per-example NLL + correctness counts (ex_mask excludes pad rows)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, label.long()[:, None])[:, 0]
    w = ex_mask.to(logp.dtype)
    correct = ((torch.argmax(logits, -1) == label.long()).to(logp.dtype) * w).sum()
    return {"correct": correct, "count": w.sum(), "loss_sum": (nll * w).sum()}


def _loss(m: dict[str, torch.Tensor]) -> torch.Tensor:
    return m["loss_sum"] / torch.clamp(m["count"], min=1.0)


def loss_and_metrics(model: FVTAModel, shared: SharedTables, batch: Batch, train: bool,
                     generator: torch.Generator | None = None, vocab_table=None,
                     photo_table=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked 4-way cross-entropy + accuracy counts. vocab_table / photo_table:
    optional precomputed per-checkpoint tables (frozen-parameter evaluation)."""
    mi = assemble(shared, batch, photo_table)
    out = model(shared, mi, vocab_table, train=train, generator=generator)
    m = masked_choice_metrics(out.logits, mi.label, mi.ex_mask)
    return _loss(m), m


def dedup_album_batch(album_idx: np.ndarray, u_cap: int):
    """Host-side unique + inverse over a batch's album ids [N, A] (0 = pad).
    Returns (uniq [u_cap] int32 padded with 0, inv [N, A] int32 with
    uniq[inv] == album_idx), or None when the batch has more than u_cap
    distinct ids (the caller then runs the plain step)."""
    a = np.asarray(album_idx)
    uniq, inv = np.unique(a, return_inverse=True)
    if len(uniq) > u_cap:
        return None
    pad = u_cap - len(uniq)
    if pad:
        uniq = np.concatenate([uniq, np.zeros(pad, uniq.dtype)])
    return uniq.astype(np.int32), inv.reshape(a.shape).astype(np.int32)


def dedup_u_cap(cfg: Config) -> int:
    """Static unique-buffer size: ceil(dedup_cap * N * A), rounded up to a
    multiple of 8, clamped to [8, N*A]."""
    slots = cfg.train.batch_size * cfg.data.max_albums
    cap = math.ceil(cfg.train.dedup_cap * slots / 8) * 8
    return max(8, min(cap, slots))


def dedup_loss_and_metrics(model: FVTAModel, shared: SharedTables, batch: Batch,
                           uniq: torch.Tensor, inv: torch.Tensor, train: bool,
                           generator: torch.Generator | None = None):
    """loss_and_metrics through the dedup context encode: each distinct album
    encodes once ([U, 6, T, 2H]); per-question context rows come from
    gather_cached_context, whose backward sums duplicate slots' gradients onto
    their shared encode. The query side reads only the batch's query fields."""
    vt = model._tables(shared, None)   # once per step, shared by both halves
    mi_u = assemble_albums(a1_config(model.cfg).data, shared, uniq)
    h_u, m_u = model.encode_context(shared, mi_u, vt, train=train, generator=generator)
    h_ctx, ctx_mask = gather_cached_context(h_u, m_u, inv, batch.album_mask)
    out = model.answer(shared, batch, h_ctx, ctx_mask, vt, train=train,
                       generator=generator)
    m = masked_choice_metrics(out.logits, batch.label, batch.ex_mask)
    return _loss(m), m


def _apply(state: TrainState, opt: Optimizer, loss: torch.Tensor, m: dict) -> dict:
    params = state.params
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    opt.update(params, {n: torch.zeros_like(p) if g is None else g
                        for (n, p), g in zip(params.items(), grads)}, state.opt_state)
    state.step += 1
    return {"loss": loss.detach(), "acc": m["correct"] / torch.clamp(m["count"], min=1.0)}


def train_step(state: TrainState, opt: Optimizer, shared: SharedTables,
               batch: Batch) -> dict[str, torch.Tensor]:
    """One optimizer step on a device batch; moves state in place. Returns
    {"loss", "acc"} as device scalars (no host sync)."""
    loss, m = loss_and_metrics(state.model, shared, batch, True, state.generator)
    return _apply(state, opt, loss, m)


def dedup_train_step(state: TrainState, opt: Optimizer, shared: SharedTables,
                     batch: Batch, uniq: torch.Tensor, inv: torch.Tensor
                     ) -> dict[str, torch.Tensor]:
    """train_step through the dedup encode; uniq/inv from dedup_album_batch."""
    loss, m = dedup_loss_and_metrics(state.model, shared, batch, uniq, inv, True,
                                     state.generator)
    return _apply(state, opt, loss, m)


def make_eval_tables(model: FVTAModel, shared: SharedTables):
    """(vocab_table, photo_table) for frozen-parameter consumers."""
    return make_vocab_table(model, shared), make_photo_table(model, shared)


def make_eval_step(model: FVTAModel):
    """(shared, device batch, vocab_table, photo_table) → the batch's metric
    sums, without grad."""
    @torch.no_grad()
    def eval_step(shared, batch, vocab_table=None, photo_table=None):
        return loss_and_metrics(model, shared, batch, False, None, vocab_table,
                                photo_table)[1]
    return eval_step


def evaluate(eval_step, shared: SharedTables, dataset: Dataset, batch_size: int,
             vocab_table=None, photo_table=None) -> dict:
    """Full-split evaluation → {"acc", "loss", "count"}. Sums stay on the
    device and are fetched once at the end."""
    device = shared.word_emb.device
    totals = None
    for batch in dataset.get_batches(batch_size, shuffle=False):
        m = eval_step(shared, batch.to(device), vocab_table, photo_table)
        totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
    totals = ({k: float(v) for k, v in totals.items()} if totals is not None
              else {"correct": 0.0, "count": 0.0, "loss_sum": 0.0})
    return {"acc": totals["correct"] / max(totals["count"], 1.0),
            "loss": totals["loss_sum"] / max(totals["count"], 1.0),
            "count": int(totals["count"])}


@contextlib.contextmanager
def deterministic_algorithms(device: torch.device):
    """torch's deterministic algorithms for the run, restored afterwards. The
    index backward (`vocab_table[words]`, the dedup gather) otherwise adds with
    atomics in a thread-dependent order — on the CPU as on the card — and two
    identical runs then differ in the last bits. On the card cuBLAS also needs
    a fixed workspace (CUBLAS_WORKSPACE_CONFIG)."""
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def train(cfg: Config, packed, out_dir: str, num_steps: int | None = None,
          metrics_path: str | None = None, echo: bool = True,
          device="cuda") -> dict:
    """Full training: epochs over the train split, periodic val, keep-best
    checkpoints, exact resume from out_dir's latest checkpoint. At the end the
    run directory gets the port's params.pt (best-on-val, else latest), so
    `cli predict <pack> <out_dir>` serves the trained model.

    Returns {"best_val_acc", "steps", "state", "model", "shared"}."""
    if cfg.mesh.num_devices > 1:
        raise NotImplementedError("data/context parallel training is not ported yet; "
                                  "use MeshConfig(data_parallel=1, context_parallel=1)")
    dev = resolve_device(device)
    with deterministic_algorithms(dev), torch.autograd.set_detect_anomaly(
            debug_nans_enabled()):
        return _train(cfg, packed, out_dir, num_steps, metrics_path, echo, dev)


def _train(cfg, packed, out_dir, num_steps, metrics_path, echo, dev) -> dict:
    t = cfg.train
    shared = SharedTables.from_packed(packed.shared, dev)
    train_ds = Dataset(packed, "train")
    val_ds = (Dataset(packed, "val") if packed.splits.get("val") is not None
              and len(packed.splits["val"]["label"]) else None)
    state = init_state(cfg, dev)
    opt = Optimizer(t)
    ckpt = CheckpointManager(out_dir, cfg, max_to_keep=t.keep_checkpoints)
    nb = max(train_ds.num_batches(t.batch_size), 1)
    start_epoch = skip_batches = 0
    if ckpt.latest_step() is not None:
        ckpt.restore(state)
        # the data order is a function of (seed, epoch): step mod batches-per-
        # epoch is where the killed run stopped in the same stream
        start_epoch, skip_batches = divmod(state.step, nb)
    use_dedup = t.dedup_albums
    u_cap = dedup_u_cap(cfg) if use_dedup else 0

    log = MetricsLogger(metrics_path, echo=echo)
    timer = Timer()
    best_val = -1.0
    done = False
    window_steps = 0
    model = state.model
    eval_step = make_eval_step(model)

    def validate(step: int) -> None:
        nonlocal best_val
        vm = evaluate(eval_step, shared, val_ds, t.eval_batch_size,
                      *make_eval_tables(model, shared))
        log.log("val", step=step, acc=vm["acc"], loss=vm["loss"])
        best_val = max(best_val, vm["acc"])
        ckpt.save(step, state, val_acc=vm["acc"])

    try:
        for epoch in range(start_epoch, t.num_epochs):
            if done:
                break
            batch_it = train_ds.get_batches(t.batch_size, shuffle=True, seed=t.seed,
                                            epoch=epoch)
            if epoch == start_epoch and skip_batches:
                batch_it = itertools.islice(batch_it, skip_batches, None)
            for batch in batch_it:
                dd = dedup_album_batch(batch.album_idx.numpy(), u_cap) if use_dedup else None
                batch = batch.to(dev)
                if not timer.samples and not timer.running:
                    timer.start()   # the window opens on the first step after a log
                if dd is not None:
                    m = dedup_train_step(state, opt, shared, batch,
                                         *(torch.from_numpy(a).to(dev) for a in dd))
                else:
                    m = train_step(state, opt, shared, batch)
                window_steps += 1
                step = state.step
                if step % t.log_period == 0:
                    loss = float(m["loss"])   # the only host sync between logs
                    check_finite_loss(loss, step)
                    timer.stop()
                    window = timer.samples[-1]
                    n_steps = max(window_steps, 1)
                    log.log("train", step=step, epoch=epoch, loss=loss, acc=float(m["acc"]),
                            qa_pairs_per_sec=t.batch_size * n_steps / max(window, 1e-9),
                            p50_step_ms=window / n_steps * 1e3)
                    timer.reset()
                    window_steps = 0
                if val_ds is not None and step % t.val_period == 0:
                    validate(step)
                    # val wall time is not training throughput
                    timer.reset()
                    window_steps = 0
                elif step % t.save_period == 0:
                    ckpt.save(step, state)
                if num_steps is not None and step >= num_steps:
                    done = True
                    break

        step = state.step
        if val_ds is not None:
            validate(step)
        else:
            ckpt.save(step, state)
        best = FVTAModel(cfg)
        best.load_state_dict(ckpt.load(best=True)["params"])
        save_rundir(out_dir, cfg, best)
    finally:
        log.close()
    return {"best_val_acc": best_val, "steps": state.step, "state": state,
            "model": model, "shared": shared}


# ---- evaluation of a run directory (`cli test`) -------------------------------------

def restore_model(cfg: Config, out_dir: str, load_best: bool, device) -> FVTAModel:
    """FVTAModel(cfg) holding the best-on-val (or the latest) checkpoint of
    out_dir, on `device`, in eval mode."""
    model = FVTAModel(cfg)
    model.load_state_dict(CheckpointManager(out_dir).load(best=load_best)["params"])
    return model.to(device).eval()


@torch.no_grad()
def dump_attention(model: FVTAModel, shared: SharedTables, dataset: Dataset,
                   batch_size: int, path: str) -> int:
    """Per-question FVTA attention maps and predictions → .npz: qid [N], pred
    [N], label [N], probs [N, 4], time_attn [N, S, T] (focal weights within
    each sequence), seq_attn [N, S] (weights across sequences) — the tensors
    behind the paper's qualitative attention figures. Returns the number of
    questions written."""
    vt, pt = make_eval_tables(model, shared)
    dev = shared.word_emb.device
    rows = {k: [] for k in ("qid", "pred", "label", "probs", "time_attn", "seq_attn")}
    qids = dataset.qids
    seen = 0
    for batch in dataset.get_batches(batch_size, shuffle=False):
        out = model(shared, assemble(shared, batch.to(dev), pt), vt)
        probs = torch.softmax(out.logits, -1).cpu().numpy()
        keep = batch.ex_mask.numpy()
        n = int(keep.sum())
        rows["qid"].append(qids[seen: seen + n])
        rows["pred"].append(np.argmax(probs, -1)[keep])
        rows["label"].append(batch.label.numpy()[keep])
        rows["probs"].append(probs[keep])
        rows["time_attn"].append(out.attention.time_attn.cpu().numpy()[keep])
        rows["seq_attn"].append(out.attention.seq_attn.cpu().numpy()[keep])
        seen += n
    np.savez_compressed(path, **{k: np.concatenate(v) for k, v in rows.items()})
    return seen


def _by_category(packed, split: str, correct: np.ndarray) -> dict:
    return accuracy_by_category(question_categories(packed, split), correct)


def test(cfg: Config, packed, out_dir: str, load_best: bool = True, split: str = "test",
         metrics_path: str | None = None, echo: bool = True, album_cache: bool = True,
         attention_path: str | None = None, by_category: bool = False,
         shard_cache: bool = False, device="cuda") -> dict:
    """The reference's `main.py --is_test`: restore the best (or the latest)
    checkpoint of out_dir and report {"acc", "loss", "count"} on a split.

    album_cache=True (the default) evaluates through eval_cache (each album
    encoded once; the same logits); album_cache=False re-encodes every
    question's albums, as the reference does. attention_path: also write the
    attention maps (dump_attention). by_category: also report the papers'
    per-category accuracy (what/who/when/where/how-many, data/categories.py)
    under m["by_category"], from predict_cached over an album cache — built
    here also when album_cache=False (the JAX package's train.test raises
    UnboundLocalError on that combination, train.py:699/731).
    A data-parallel mesh (cfg.mesh.num_devices > 1) and shard_cache raise
    NotImplementedError: they belong to the data-parallel slice."""
    if shard_cache or cfg.mesh.num_devices > 1:
        raise NotImplementedError(SHARD_CACHE_NOT_PORTED)
    dev = resolve_device(device)
    model = restore_model(cfg, out_dir, load_best, dev)
    shared = SharedTables.from_packed(packed.shared, dev)
    ds = Dataset(packed, split)
    bs = cfg.train.eval_batch_size
    timer = Timer()
    timer.start()
    tables = make_eval_tables(model, shared)   # built once, for every pass below
    cache = None                               # likewise (by_category builds it if None)
    if album_cache:
        cache = precompute_album_cache(cfg, model, shared, vocab_table=tables[0],
                                       photo_table=tables[1])
        m = evaluate_cached(cfg, model, shared, ds, bs, cache=cache, tables=tables)
    else:
        m = evaluate(make_eval_step(model), shared, ds, bs, *tables)
    timer.stop()
    log = MetricsLogger(metrics_path, echo=echo)
    try:
        log.log("test", split=split, acc=m["acc"], loss=m["loss"], count=m["count"],
                wall_s=timer.samples[0])
        if by_category:
            pr = predict_cached(cfg, model, shared, ds, bs, cache=cache, tables=tables)
            m["by_category"] = _by_category(packed, split, pr["pred"] == pr["label"])
            log.log("test_by_category", split=split,
                    **{k: v["acc"] for k, v in m["by_category"].items()})
        if attention_path:
            n = dump_attention(model, shared, ds, bs, attention_path)
            log.log("attention_dump", split=split, path=attention_path, count=n)
    finally:
        log.close()
    return m


def test_ensemble(cfg: Config, packed, out_dirs: list[str], load_best: bool = True,
                  split: str = "test", metrics_path: str | None = None, echo: bool = True,
                  by_category: bool = False, shard_cache: bool = False,
                  device="cuda") -> dict:
    """Checkpoint ensembling: average the per-question choice probabilities of
    several runs on one pack (each restored under its own saved config.json,
    with the caller's eval_batch_size) and take the argmax of the mean.
    Returns {"acc", "count", "members": [{"dir", "acc"}], ["by_category"]}."""
    if shard_cache or cfg.mesh.num_devices > 1:
        raise NotImplementedError(SHARD_CACHE_NOT_PORTED)
    dev = resolve_device(device)
    shared = SharedTables.from_packed(packed.shared, dev)
    ds = Dataset(packed, split)
    probs_sum, labels, members = None, None, []
    for d in out_dirs:
        cfg_path = os.path.join(d, "config.json")
        mcfg = (load_config(cfg_path) if os.path.exists(cfg_path) else cfg).replace(
            data=packed.cfg)
        # the member's config owns the architecture; batching follows the caller
        mcfg = mcfg.replace(train=dataclasses.replace(
            mcfg.train, eval_batch_size=cfg.train.eval_batch_size))
        model = restore_model(mcfg, d, load_best, dev)
        pr = predict_cached(mcfg, model, shared, ds, mcfg.train.eval_batch_size)
        if labels is None:
            labels = pr["label"]
        members.append({"dir": d, "acc": float((pr["pred"] == pr["label"]).mean())})
        probs_sum = pr["probs"] if probs_sum is None else probs_sum + pr["probs"]
    correct = np.argmax(probs_sum / len(out_dirs), -1) == labels
    m = {"acc": float(correct.mean()), "count": int(labels.shape[0]), "members": members}
    log = MetricsLogger(metrics_path, echo=echo)
    try:
        log.log("test_ensemble", split=split, acc=m["acc"], count=m["count"],
                member_accs=[mm["acc"] for mm in members])
        if by_category:
            m["by_category"] = _by_category(packed, split, correct)
            log.log("test_by_category", split=split,
                    **{k: v["acc"] for k, v in m["by_category"].items()})
    finally:
        log.close()
    return m
