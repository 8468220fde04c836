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

The step as a CUDA graph (StepGraph): on the card, a single-rank step without
dedup, gradient accumulation or anomaly detection is captured once (forward,
backward, the clip and Adam) and replayed from then on, so the host makes a few
dozen calls a step in place of ~2300 launches. The first such call runs
eagerly, the next captures; a step whose key (graph_key: the tensors the graph
reads and writes, the batch's shapes, the numerics settings) differs from the
held graph's runs eagerly again and the next recaptures. Every other step runs
eagerly (eager_step), as PyTorch runs it. Both give the same bits.

Train-time album dedup (TrainConfig.dedup_albums) encodes each distinct album
of a batch once and gathers per-question context rows from the unique encodes
(eval_cache.gather_cached_context); at keep_prob = 1 it is the same function
of the parameters as the plain step.

The loader: the train and val splits come from the pack in memory or from any
Dataset-like pair (`datasets=`, e.g. data.stream.StreamingDataset over shard
files); `prefetch=` moves batch preparation, dedup and the move to the device
into a background thread; `profile_dir=` traces steps 11-15 with torch.profiler.

Evaluation of a run directory (`cli test`): `test` restores the best or the
latest checkpoint and evaluates a split, through the album cache
(eval_cache.py) or with a full re-encode per question, optionally with the
per-category table and an attention dump (`dump_attention`); `test_ensemble`
averages several runs' choice probabilities.

Data parallelism (MeshConfig.data_parallel > 1) runs one process per rank
(parallel/mesh.py): outside a process group `train`, `test` and
`test_ensemble` launch the ranks on themselves (mesh.launches_ranks) and
return rank 0's result; inside one (torchrun, or the launched ranks) each rank runs its
part. Every rank reads the whole batch and computes on its rows
(mesh.take_rows): dropout draws the whole batch's mask and keeps its rows
(models/fvta.dropout_row_shard), each rank's loss is its rows' loss sum over
the batch's example count, and the flat gradient and the metric sums are
all-gathered and summed in rank order, so every rank holds the same bits and
applies the same update. The dedup step keeps the batch-wide dedup: each rank
encodes its U/dp unique albums and mesh.GatherShards rebuilds all U. Context
ranks (MeshConfig.context_parallel) are replicas here, as in the JAX package,
whose batch shards over "data" only. Rank 0 writes the checkpoints, the
metrics and the run directory; the others wait at a barrier; every rank
restores, and a checkpoint resumes at any world size. Evaluation shards each
batch's rows the same way; `test(shard_cache=True)` row-shards the album
cache (eval_cache.shard_album_cache).
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
from fvta_memexqa_torch.config import Config, MeshConfig, load_config
from fvta_memexqa_torch.convert import save_rundir
from fvta_memexqa_torch.data.device_prepro import Batch, SharedTables, assemble, assemble_albums
from fvta_memexqa_torch.data.pipeline import Dataset
from fvta_memexqa_torch.data.stream import Prefetcher
from fvta_memexqa_torch.data.categories import accuracy_by_category, question_categories
from fvta_memexqa_torch.eval_cache import (_sharded_cache_setup, evaluate_cached,
                                           gather_cached_context, precompute_album_cache,
                                           predict_cached)
from fvta_memexqa_torch.models.fvta import (FVTAModel, a1_config, dropout_row_shard,
                                            make_photo_table, make_vocab_table)
from fvta_memexqa_torch.ops import build
from fvta_memexqa_torch.optim import DeviceScalars, Optimizer
from fvta_memexqa_torch.parallel import mesh
from fvta_memexqa_torch.serve import resolve_device
from fvta_memexqa_torch.utils.metrics import MetricsLogger, Timer, span


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
    graph: "StepGraph | None" = dataclasses.field(default=None, compare=False, repr=False)

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


def loss_and_metrics(model: FVTAModel, shared: SharedTables, batch: Batch, train: bool,
                     generator: torch.Generator | None = None, vocab_table=None,
                     photo_table=None, dd=None, rank: mesh.Rank | None = None
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked 4-way cross-entropy + accuracy counts of a device batch → (loss,
    sums). vocab_table / photo_table: optional precomputed per-checkpoint
    tables (frozen-parameter evaluation). dd: the batch's (uniq, inv) from
    dedup_album_batch, the context encoded once per distinct album
    (dedup_forward). rank: data parallelism (the module docstring): the sums
    are this data rank's rows', dropout is drawn for the whole batch. The loss
    is the rows' loss sum over the whole batch's example count."""
    local = rank_batch(batch, rank)
    count = torch.clamp(batch.ex_mask.sum().to(torch.float32), min=1.0)
    with (contextlib.nullcontext() if rank is None
          else dropout_row_shard(rank.data, rank.layout.data_parallel)):
        if dd is None:
            mi = assemble(shared, local, photo_table)
            out = model(shared, mi, vocab_table, train=train, generator=generator)
        else:
            out = dedup_forward(model, shared, local, *dd, train, generator, vocab_table,
                                rank)
    m = masked_choice_metrics(out.logits, local.label, local.ex_mask)
    return m["loss_sum"] / count, m


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


def dp_u_cap(cfg: Config) -> int:
    """dedup_u_cap rounded up to a multiple of lcm(8, data_parallel) (at most
    N*A), so the unique albums split evenly over the data ranks."""
    u_cap = dedup_u_cap(cfg)
    dp = cfg.mesh.data_parallel
    if dp <= 1:
        return u_cap
    mult = math.lcm(8, dp)
    return min(-(-u_cap // mult) * mult, cfg.train.batch_size * cfg.data.max_albums)


def dedup_forward(model: FVTAModel, shared: SharedTables, batch: Batch, uniq: torch.Tensor,
                  inv: torch.Tensor, train: bool, generator: torch.Generator | None = None,
                  vocab_table=None, rank: mesh.Rank | None = None):
    """The model's output through the dedup context encode: each distinct
    album encodes once ([U, 6, T, 2H]); per-question context rows come from
    gather_cached_context, whose backward sums duplicate slots' gradients onto
    their shared encode. The query side reads only the batch's query fields.
    rank: `batch` holds this data rank's rows; the rank encodes its U/dp of
    the unique albums and mesh.GatherShards rebuilds all U (its backward
    returns each album's summed cotangent to the rank that encoded it)."""
    vt = model._tables(shared, vocab_table)   # once per step, shared by both halves
    if rank is not None:
        dp = rank.layout.data_parallel
        uniq, inv = mesh.take_rows(uniq, rank.data, dp), mesh.take_rows(inv, rank.data, dp)
    mi_u = assemble_albums(a1_config(model.cfg).data, shared, uniq)
    h_u, m_u = model.encode_context(shared, mi_u, vt, train=train, generator=generator)
    if rank is not None:
        h_u = mesh.GatherShards.apply(h_u, rank.data_group())
        m_u = torch.cat(mesh.all_gather(m_u, rank.data_group()))
    h_ctx, ctx_mask = gather_cached_context(h_u, m_u, inv, batch.album_mask)
    return model.answer(shared, batch, h_ctx, ctx_mask, vt, train=train, generator=generator)


def data_sum(x: torch.Tensor, rank: mesh.Rank | None) -> torch.Tensor:
    """x summed over the data ranks in rank order (identical on every rank);
    x itself outside a process group."""
    return x if rank is None else mesh.sum_across(x, rank.data_group())


def step_grads(model: FVTAModel, shared: SharedTables, batch: Batch, dd=None,
               rank: mesh.Rank | None = None, train: bool = True,
               generator: torch.Generator | None = None
               ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """The gradient of loss_and_metrics' loss and the batch's sums: ({name:
    grad}, [loss_sum, correct, count]). rank: the flat gradient and the sums
    are all-gathered over the data ranks and summed in rank order, so every
    rank holds the same bits."""
    with span("fvta.forward"):
        loss, m = loss_and_metrics(model, shared, batch, train, generator, dd=dd, rank=rank)
    params = dict(model.named_parameters())
    with span("fvta.backward"):
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params.values(), grads)]
        sums = torch.stack([m["loss_sum"], m["correct"], m["count"]]).detach()
        if rank is not None:
            total = data_sum(torch.cat([*(g.reshape(-1) for g in grads), sums]), rank)
            sizes = [p.numel() for p in params.values()]
            *flat, sums = total.split([*sizes, 3])
            grads = [f.view_as(p) for f, p in zip(flat, params.values())]
    return dict(zip(params, grads)), sums


def train_step(state: TrainState, opt: Optimizer, shared: SharedTables, batch: Batch,
               dd=None, rank: mesh.Rank | None = None) -> dict[str, torch.Tensor]:
    """One optimizer step on a device batch (dd, rank: as in loss_and_metrics;
    every data rank applies the same update); moves state in place. Returns
    {"loss", "acc"} as new device scalars (no host sync). On the card a step
    that graph_eligible admits runs from a CUDA graph (StepGraph), else
    eagerly. Spans: fvta.step around the whole; fvta.replay around a replay's
    staging and launch; an eager step's fvta.forward, fvta.backward and
    fvta.optimizer. Counts its paths in `train_step.eager_steps`,
    `.graph_captures` and `.graph_replays`."""
    with span("fvta.step"):
        eligible = graph_eligible(batch.label.is_cuda, rank, dd, opt.tcfg.grad_accum,
                                  torch.is_anomaly_enabled())
        key = graph_key(state, opt, shared, batch) if eligible else None
        path = step_path(eligible, key, state.graph)
        if path == "eager":
            return eager_step(state, opt, shared, batch, dd, rank)
        if path == "first":
            state.graph = StepGraph(key)   # the next step with this key captures
            return eager_step(state, opt, shared, batch)
        if path == "capture":
            state.graph.capture(state, opt, shared, batch)
        with span("fvta.replay"):
            return state.graph.replay(state, opt, batch)


def eager_step(state: TrainState, opt: Optimizer, shared: SharedTables, batch: Batch,
               dd=None, rank: mesh.Rank | None = None) -> dict[str, torch.Tensor]:
    """train_step's work launched op by op: step_grads, then Optimizer.update."""
    grads, sums = step_grads(state.model, shared, batch, dd, rank, True, state.generator)
    with span("fvta.optimizer"):
        opt.update(state.params, grads, state.opt_state)
    state.step += 1
    _count_step("eager_steps")
    return step_metrics(*sums)


def step_metrics(loss_sum: torch.Tensor, correct: torch.Tensor,
                 count: torch.Tensor) -> dict[str, torch.Tensor]:
    count = torch.clamp(count, min=1.0)
    return {"loss": loss_sum / count, "acc": correct / count}


def graph_eligible(cuda: bool, rank: mesh.Rank | None, dd, grad_accum: int,
                   anomaly: bool) -> bool:
    """Whether train_step may run a step from a CUDA graph, from what the call
    observes: a batch on the card, one rank (a data rank's step holds a
    collective), no dedup (its unique-album count sets shapes per batch), no
    gradient accumulation (a host branch on the micro-step) and no anomaly
    detection (it checks each backward op on the host)."""
    return cuda and rank is None and dd is None and grad_accum == 1 and not anomaly


def graph_key(state: TrainState, opt: Optimizer, shared: SharedTables, batch: Batch) -> tuple:
    """What a captured step is bound to: the identity and address of every tensor
    it reads or writes in place (parameters, the optimizer's moments, the shared
    tables), the optimizer and the dropout generator, the batch's shapes and
    dtypes, and the settings that choose kernels (deterministic algorithms,
    TF32). A resume that rebinds the state changes it."""
    tensors = [*state.model.parameters(), *vars(shared).values()]
    for v in state.opt_state.values():
        if isinstance(v, dict):
            tensors += v.values()
    return (id(opt), id(state.generator), [*map(id, tensors)], [t.data_ptr() for t in tensors],
            [(t.shape, t.dtype, t.device) for t in vars(batch).values()],
            torch.are_deterministic_algorithms_enabled(),
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def step_path(eligible: bool, key, graph: "StepGraph | None") -> str:
    """How train_step runs a step: "eager" (not eligible), "first" (eligible,
    but no graph holds this key: an eager step, and the next call with the key
    captures), "capture" (the previous step ran eagerly with this key) or
    "replay"."""
    if not eligible:
        return "eager"
    if graph is None or graph.key != key:
        return "first"
    return "capture" if graph.graph is None else "replay"


class StepGraph:
    """One train step (step_grads, Optimizer.update, the step's metrics)
    captured as a CUDA graph and replayed onto the same parameters, moments and
    generator. The batch is copied into the graph's own input tensors and the
    optimizer's per-step scalars into DeviceScalars before each replay; the
    dropout generator is registered with the graph, so each replay draws what
    an eager step would and advances it alike. The kernel wrappers' launch
    counters move by the captured launches at each replay, not at the
    capture."""

    def __init__(self, key: tuple):
        self.key = key
        self.graph = None

    def capture(self, state: TrainState, opt: Optimizer, shared: SharedTables,
                batch: Batch) -> None:
        self.inputs = Batch(**{k: v.clone() for k, v in vars(batch).items()})
        self.scalars = DeviceScalars(batch.label.device)
        self.launches = build.LaunchRecord()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        # thread_local: a prefetching loader thread may copy to the card meanwhile
        with self.launches.capturing(), torch.cuda.graph(graph,
                                                         capture_error_mode="thread_local"):
            grads, sums = step_grads(state.model, shared, self.inputs, None, None, True,
                                     state.generator)
            opt.update(state.params, grads, state.opt_state, self.scalars)
            m = step_metrics(*sums)
            self.out = torch.stack([m["loss"], m["acc"]])   # one copy out a replay
        self.graph = graph
        _count_step("graph_captures")

    def replay(self, state: TrainState, opt: Optimizer, batch: Batch) -> dict[str, torch.Tensor]:
        for k, v in vars(batch).items():
            getattr(self.inputs, k).copy_(v)
        self.scalars.fill(opt.advance(state.opt_state))
        self.graph.replay()
        self.launches.replayed()
        state.step += 1
        _count_step("graph_replays")
        loss, acc = self.out.clone()
        return {"loss": loss, "acc": acc}


def _count_step(path: str) -> None:
    setattr(_STEP, path, getattr(_STEP, path) + 1)


_STEP = train_step   # the counters stay on the function a test may wrap
train_step.eager_steps = train_step.graph_captures = train_step.graph_replays = 0


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


@contextlib.contextmanager
def on_device(batches, transfer, prefetch: int):
    """An iterator of transfer(batch) over `batches`: inline, or `prefetch`
    batches ahead in a background thread (data.stream.Prefetcher, whose worker
    exception is re-raised here), stopped when the block is left."""
    if prefetch <= 0:
        yield map(transfer, batches)
        return
    with Prefetcher(batches, depth=prefetch, transfer=transfer) as it:
        yield it


def rank_batch(batch, rank: mesh.Rank | None):
    """This data rank's rows of a batch (the whole batch outside a group)."""
    return batch if rank is None else mesh.take_rows(batch, rank.data,
                                                     rank.layout.data_parallel)


def evaluate(eval_step, shared: SharedTables, dataset, batch_size: int,
             vocab_table=None, photo_table=None, prefetch: int = 0,
             rank: mesh.Rank | None = None) -> dict:
    """Full-split evaluation → {"acc", "loss", "count"}. Sums stay on the
    device and are fetched once at the end. prefetch > 0: batches are prepared
    and moved to the device `prefetch` ahead in a background thread. rank:
    each data rank evaluates its rows of every batch and the sums are added
    over the data ranks in rank order."""
    device = shared.word_emb.device
    totals = None
    with on_device(dataset.get_batches(batch_size, shuffle=False),
                   lambda b: rank_batch(b, rank).to(device), prefetch) as batches:
        for batch in batches:
            m = eval_step(shared, batch, vocab_table, photo_table)
            totals = m if totals is None else {k: totals[k] + m[k] for k in totals}
    if totals is not None and rank is not None:
        summed = data_sum(torch.stack([totals[k] for k in ("correct", "count",
                                                           "loss_sum")]), rank)
        totals = dict(zip(("correct", "count", "loss_sum"), summed))
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


PROFILE_STEPS = (10, 15)   # the profiled window: from after step 10 to step 15


def _dp_mesh(*batch_size_fields: str):
    """mesh_of for mesh.launches_ranks: cfg.mesh, after checking that each
    named TrainConfig batch size splits over the data ranks."""
    def mesh_of(kw) -> MeshConfig:
        cfg = kw["cfg"]
        dp = cfg.mesh.data_parallel
        for name in batch_size_fields:
            bs = getattr(cfg.train, name)
            if bs % dp:
                raise ValueError(f"batch size {bs} must be divisible by the data-parallel "
                                 f"degree {dp}")
        return cfg.mesh
    return mesh_of


@mesh.launches_ranks(_dp_mesh("batch_size", "eval_batch_size"))
def train(cfg: Config, packed, out_dir: str, num_steps: int | None = None,
          metrics_path: str | None = None, echo: bool = True,
          profile_dir: str | None = None, datasets=None, prefetch: int = 0,
          device="cuda", devices: list | None = None) -> dict:
    """Full training: epochs over the train split, periodic val, keep-best
    checkpoints, exact resume from out_dir's latest checkpoint. At the end the
    run directory gets the port's params.pt (best-on-val, else latest), so
    `cli predict <pack> <out_dir>` serves the trained model.

    datasets: optional (train_ds, val_ds | None) in place of the pack's
    in-memory splits — any objects with Dataset's num_batches / get_batches,
    e.g. data.stream.StreamingDataset (then `packed` need hold only meta and
    the shared tables). prefetch > 0: batch preparation, the dedup of its album
    ids and the move to the device run in a background thread, `prefetch`
    batches ahead (data.stream.Prefetcher), for validation too. profile_dir:
    a torch.profiler window over steps 11-15 (CPU and CUDA activity on the
    card), written there as a chrome trace and logged as a `profile` event.

    cfg.mesh.num_devices > 1: data-parallel training (the module docstring),
    one process per rank: outside a process group the ranks are launched here
    (mesh.launches_ranks over make_mesh(cfg.mesh, devices, device): by default
    one rank per card, or CPU ranks for device="cpu") and rank 0's result is
    returned, its tensors on the CPU.

    Returns {"best_val_acc", "steps", "state", "model", "shared"}."""
    rank = mesh.current_rank(cfg.mesh, devices, device)
    dev = resolve_device(rank.device if rank else device)
    with deterministic_algorithms(dev), torch.autograd.set_detect_anomaly(
            debug_nans_enabled()):
        return _train(cfg, packed, out_dir, num_steps, metrics_path, echo, dev,
                      profile_dir, datasets, prefetch, rank)


class _ProfileWindow:
    """torch.profiler over one window of steps, opened once: `open` before the
    step after PROFILE_STEPS[0], `close` after PROFILE_STEPS[1] (or where the
    run ends inside the window). It synchronizes the card before it stops,
    writes a chrome trace (torch's format) into the directory and logs the
    `profile` event with the JAX package's keys."""

    def __init__(self, profile_dir: str | None, dev: torch.device, log: MetricsLogger):
        self.dir, self.dev, self.log = profile_dir, dev, log
        self.prof = None

    def open(self, steps_done: int) -> None:
        if self.dir and steps_done == PROFILE_STEPS[0]:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def close(self, step: int) -> None:
        if self.prof is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self.prof = None
        self.log.log("profile", step=step, dir=self.dir)


def rank_checkpoints(out_dir: str, cfg: Config, keep: int,
                     first: bool) -> CheckpointManager:
    """The run's CheckpointManager: rank 0 writes config.json, the others open
    the directory after the barrier."""
    ckpt = CheckpointManager(out_dir, cfg, max_to_keep=keep) if first else None
    mesh.barrier()
    return ckpt or CheckpointManager(out_dir, max_to_keep=keep)


def _train(cfg, packed, out_dir, num_steps, metrics_path, echo, dev, profile_dir,
           datasets, prefetch, rank=None) -> dict:
    t = cfg.train
    first = rank is None or rank.is_first
    shared = SharedTables.from_packed(packed.shared, dev)
    if datasets is not None:
        train_ds, val_ds = datasets
    else:
        train_ds = Dataset(packed, "train")
        val_ds = (Dataset(packed, "val") if packed.splits.get("val") is not None
                  and len(packed.splits["val"]["label"]) else None)
    state = init_state(cfg, dev)
    opt = Optimizer(t)
    ckpt = rank_checkpoints(out_dir, cfg, t.keep_checkpoints, first)
    nb = max(train_ds.num_batches(t.batch_size), 1)
    start_epoch = skip_batches = 0
    if ckpt.latest_step() is not None:
        ckpt.restore(state)   # every rank, from whatever world size wrote it
        # the data order is a function of (seed, epoch): step mod batches-per-
        # epoch is where the killed run stopped in the same stream
        start_epoch, skip_batches = divmod(state.step, nb)
    use_dedup = t.dedup_albums
    u_cap = dp_u_cap(cfg) if use_dedup else 0

    def save(step: int, val_acc: float | None = None) -> None:
        """Rank 0 writes; every rank leaves after the write."""
        if first:
            ckpt.save(step, state, val_acc=val_acc)
        mesh.barrier()

    def xfer_train(batch):
        """(device batch, device (uniq, inv) | None): the dedup runs on the host
        batch, before the move. In the prefetch worker the move runs on the
        same (default) stream as the steps, so it is ordered before the kernels
        that read it and the numbers are those of the inline loop."""
        dd = dedup_album_batch(batch.album_idx.numpy(), u_cap) if use_dedup else None
        return batch.to(dev), (None if dd is None
                               else tuple(torch.from_numpy(a).to(dev) for a in dd))

    log = MetricsLogger(metrics_path if first else None, echo=echo and first)
    window = _ProfileWindow(profile_dir if first else None, dev, log)
    timer = Timer()
    best_val = -1.0
    done = False
    window_steps = 0
    model = state.model
    eval_step = make_eval_step(model)

    def validate(step: int) -> None:
        nonlocal best_val
        vm = evaluate(eval_step, shared, val_ds, t.eval_batch_size,
                      *make_eval_tables(model, shared), prefetch=prefetch, rank=rank)
        log.log("val", step=step, acc=vm["acc"], loss=vm["loss"])
        best_val = max(best_val, vm["acc"])
        save(step, vm["acc"])

    try:
        for epoch in range(start_epoch, t.num_epochs):
            if done:
                break
            batch_it = train_ds.get_batches(t.batch_size, shuffle=True, seed=t.seed,
                                            epoch=epoch)
            if epoch == start_epoch and skip_batches:
                # dropped before the prefetcher: the skip costs host slicing only
                batch_it = itertools.islice(batch_it, skip_batches, None)
            with on_device(batch_it, xfer_train, prefetch) as batches:
                for batch, dd in batches:
                    window.open(state.step)
                    if not timer.samples and not timer.running:
                        timer.start()   # the window opens on the first step after a log
                    m = train_step(state, opt, shared, batch, dd, rank)
                    window_steps += 1
                    step = state.step
                    if step == PROFILE_STEPS[1]:
                        window.close(step)
                    if step % t.log_period == 0:
                        loss = float(m["loss"])   # the only host sync between logs
                        check_finite_loss(loss, step)
                        timer.stop()
                        elapsed = timer.samples[-1]
                        n_steps = max(window_steps, 1)
                        log.log("train", step=step, epoch=epoch, loss=loss,
                                acc=float(m["acc"]),
                                qa_pairs_per_sec=t.batch_size * n_steps / max(elapsed, 1e-9),
                                p50_step_ms=elapsed / n_steps * 1e3)
                        timer.reset()
                        window_steps = 0
                    if val_ds is not None and step % t.val_period == 0:
                        validate(step)
                        # val wall time is not training throughput
                        timer.reset()
                        window_steps = 0
                    elif step % t.save_period == 0:
                        save(step)
                    if num_steps is not None and step >= num_steps:
                        done = True
                        break
        window.close(state.step)   # the run ended inside the window

        step = state.step
        if val_ds is not None:
            validate(step)
        else:
            save(step)
        if first:
            best = FVTAModel(cfg)
            best.load_state_dict(ckpt.load(best=True)["params"])
            save_rundir(out_dir, cfg, best)
        mesh.barrier()
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


def _test_mesh(kw) -> MeshConfig:
    if kw["shard_cache"] and not kw["album_cache"]:
        raise ValueError("--shard-cache shards the album cache; it has no effect with "
                         "--no-album-cache")
    return _dp_mesh("eval_batch_size")(kw)


@mesh.launches_ranks(_test_mesh)
def test(cfg: Config, packed, out_dir: str, load_best: bool = True, split: str = "test",
         metrics_path: str | None = None, echo: bool = True, album_cache: bool = True,
         attention_path: str | None = None, by_category: bool = False,
         shard_cache: bool = False, device="cuda", devices: list | None = None) -> dict:
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
    cfg.mesh.num_devices > 1: data-parallel evaluation, the ranks launched as
    by `train` (rank 0's metrics returned); each data rank evaluates its rows
    of every batch. shard_cache: the album cache row-sharded over the data
    ranks (eval_cache.shard_album_cache), the same metrics; it needs a mesh
    and the album cache (ValueError otherwise)."""
    rank = mesh.current_rank(cfg.mesh, devices, device)
    first = rank is None or rank.is_first
    dev = resolve_device(rank.device if rank else device)
    model = restore_model(cfg, out_dir, load_best, dev)
    shared = SharedTables.from_packed(packed.shared, dev)
    ds = Dataset(packed, split)
    bs = cfg.train.eval_batch_size
    timer = Timer()
    timer.start()
    tables = make_eval_tables(model, shared)   # built once, for every pass below
    cache = sharded = None                     # likewise (by_category builds it if None)
    if album_cache:
        cache = precompute_album_cache(cfg, model, shared, vocab_table=tables[0],
                                       photo_table=tables[1])
        if shard_cache:   # sharded once, for both passes; the full cache is dropped
            sharded, cache = _sharded_cache_setup(rank, cache, bs), None
        m = evaluate_cached(cfg, model, shared, ds, bs, cache=cache, tables=tables,
                            rank=rank, sharded=sharded)
    else:
        m = evaluate(make_eval_step(model), shared, ds, bs, *tables, rank=rank)
    timer.stop()
    log = MetricsLogger(metrics_path if first else None, echo=echo and first)
    try:
        log.log("test", split=split, acc=m["acc"], loss=m["loss"], count=m["count"],
                wall_s=timer.samples[0])
        if by_category:
            pr = predict_cached(cfg, model, shared, ds, bs, cache=cache, tables=tables,
                                rank=rank, sharded=sharded)
            m["by_category"] = _by_category(packed, split, pr["pred"] == pr["label"])
            log.log("test_by_category", split=split,
                    **{k: v["acc"] for k, v in m["by_category"].items()})
        if attention_path:
            if first:   # rank 0 writes the whole split's maps
                n = dump_attention(model, shared, ds, bs, attention_path)
                log.log("attention_dump", split=split, path=attention_path, count=n)
            mesh.barrier()
    finally:
        log.close()
    return m


@mesh.launches_ranks(_dp_mesh("eval_batch_size"))
def test_ensemble(cfg: Config, packed, out_dirs: list[str], load_best: bool = True,
                  split: str = "test", metrics_path: str | None = None, echo: bool = True,
                  by_category: bool = False, shard_cache: bool = False,
                  device="cuda", devices: list | None = None) -> dict:
    """Checkpoint ensembling: average the per-question choice probabilities of
    several runs on one pack (each restored under its own saved config.json,
    with the caller's eval_batch_size) and take the argmax of the mean.
    cfg.mesh.num_devices > 1: each member evaluates data-parallel, as in
    `test` (shard_cache: its album cache row-sharded over the data ranks).
    Returns {"acc", "count", "members": [{"dir", "acc"}], ["by_category"]}."""
    rank = mesh.current_rank(cfg.mesh, devices, device)
    first = rank is None or rank.is_first
    dev = resolve_device(rank.device if rank else device)
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
        bs = mcfg.train.eval_batch_size
        sharded = None
        if shard_cache:
            tables = make_eval_tables(model, shared)
            sharded = _sharded_cache_setup(rank, precompute_album_cache(
                mcfg, model, shared, vocab_table=tables[0], photo_table=tables[1]), bs)
        pr = predict_cached(mcfg, model, shared, ds, bs, rank=rank, sharded=sharded)
        if labels is None:
            labels = pr["label"]
        members.append({"dir": d, "acc": float((pr["pred"] == pr["label"]).mean())})
        probs_sum = pr["probs"] if probs_sum is None else probs_sum + pr["probs"]
    correct = np.argmax(probs_sum / len(out_dirs), -1) == labels
    m = {"acc": float(correct.mean()), "count": int(labels.shape[0]), "members": members}
    log = MetricsLogger(metrics_path if first else None, echo=echo and first)
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
