"""What the parallel tests run in each rank. mesh.run_ranks pickles a function
by module and name and the spawned ranks import it, so these live apart from
the test modules, which import JAX: a rank imports only torch and the port."""

from __future__ import annotations

import torch

from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.data import SharedTables
from fvta_memexqa_torch.data.pipeline import Dataset
from fvta_memexqa_torch.eval_cache import (_sharded_cache_setup, evaluate_cached,
                                           precompute_album_cache, predict_cached)
from fvta_memexqa_torch.models.fvta import FVTAModel
from fvta_memexqa_torch.parallel import mesh
from fvta_memexqa_torch.parallel.cp import make_cp_attention


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])


def _same_on_every_rank(x: torch.Tensor) -> bool:
    return all(torch.equal(x, p) for p in mesh.all_gather(x))


def dp_grads(cfg, packed, state_dict: dict, rows: int) -> dict:
    """train.step_grads at train=False on the first train batch, plain and
    through the dedup encode, and whether every rank holds the same bits."""
    rank = mesh.current_rank(cfg.mesh, device="cpu")
    model = FVTAModel(cfg)
    model.load_state_dict(state_dict)
    shared = SharedTables.from_packed(packed.shared, "cpu")
    batch = next(iter(Dataset(packed, "train").get_batches(rows)))
    uniq, inv = tr.dedup_album_batch(batch.album_idx.numpy(), tr.dp_u_cap(cfg))
    out = {}
    for name, dd in (("plain", None), ("dedup", (torch.from_numpy(uniq),
                                                 torch.from_numpy(inv)))):
        grads, sums = tr.step_grads(model, shared, batch, dd, rank, train=False)
        out[name] = {"grads": grads, "loss": float(sums[0] / sums[2]),
                     "same": _same_on_every_rank(_flat(grads.values()))}
    return out


def train_ranks(cfg, packed, out_dir: str, num_steps: int | None = None) -> dict:
    """train.train as one rank; also whether the parameters, the optimizer
    state and the dropout generator end the same on every rank."""
    res = tr.train(cfg, packed, out_dir, num_steps=num_steps, echo=False, device="cpu")
    st = res["state"]
    opt = [v for v in st.opt_state.values() if isinstance(v, torch.Tensor)]
    opt += [t for v in st.opt_state.values() if isinstance(v, dict) for t in v.values()]
    flat = _flat([*st.params.values(), *opt, st.generator.get_state()])
    return {"steps": res["steps"], "best_val_acc": res["best_val_acc"],
            "params": {k: v.detach().clone() for k, v in st.params.items()},
            "ranks_equal": _same_on_every_rank(flat)}


def eval_variants(cfg, packed, out_dir: str) -> dict:
    """train.test as one rank: cached with the category table, uncached, and
    through the row-sharded cache."""
    kw = dict(load_best=True, split="train", echo=False, device="cpu")
    return {"cached": tr.test(cfg, packed, out_dir, by_category=True, **kw),
            "uncached": tr.test(cfg, packed, out_dir, album_cache=False, **kw),
            "sharded": tr.test(cfg, packed, out_dir, by_category=True, shard_cache=True,
                               **kw)}


def sharded_cache(cfg, packed, out_dir: str, batch_size: int) -> dict:
    """predict_cached and evaluate_cached through the replicated and the
    row-sharded cache on the data ranks."""
    rank = mesh.current_rank(cfg.mesh, device="cpu")
    model = tr.restore_model(cfg, out_dir, True, "cpu")
    shared = SharedTables.from_packed(packed.shared, "cpu")
    ds = Dataset(packed, "train")
    tables = tr.make_eval_tables(model, shared)
    cache = precompute_album_cache(cfg, model, shared, vocab_table=tables[0],
                                   photo_table=tables[1])
    sharded = _sharded_cache_setup(rank, cache, batch_size)
    kw = dict(tables=tables, rank=rank)
    return {"full_bytes": sum(t.numel() * t.element_size() for t in cache),
            "probs": predict_cached(cfg, model, shared, ds, batch_size, cache=cache, **kw),
            "probs_sharded": predict_cached(cfg, model, shared, ds, batch_size,
                                            sharded=sharded, **kw),
            "eval": evaluate_cached(cfg, model, shared, ds, batch_size, cache=cache, **kw),
            "eval_sharded": evaluate_cached(cfg, model, shared, ds, batch_size,
                                            sharded=sharded, **kw)}


def cp_attention(cases: list, similarity: str = "trilinear", device: str = "cpu") -> list:
    """make_cp_attention on each (h, cm, q, qm, params) case (numpy arrays,
    moved to `device`): the outputs (time_attn gathered along T) and the
    gradients of sum(context^2) + sum(question^2) with respect to h and the
    similarity weights, on the CPU."""
    fn = make_cp_attention(similarity)
    out = []
    for h, cm, q, qm, params in cases:
        h = torch.tensor(h, device=device, requires_grad=True)
        p = {k: torch.tensor(v, device=device, requires_grad=True) for k, v in params.items()}
        o = fn(h, torch.tensor(cm, device=device), torch.tensor(q, device=device),
               torch.tensor(qm, device=device), p)
        loss = (o.context ** 2).sum() + (o.question ** 2).sum()
        grads = torch.autograd.grad(loss, [h, *p.values()])
        time_attn = torch.cat(mesh.all_gather(o.time_attn.detach().contiguous()), 2)
        out.append({"context": o.context.detach().cpu(), "question": o.question.detach().cpu(),
                    "time_attn": time_attn.cpu(), "seq_attn": o.seq_attn.detach().cpu(),
                    "grads": [g.detach().cpu() for g in grads],
                    "same": _same_on_every_rank(_flat(grads[1:]))})
    return out


def flagship_cp(cfg, state_dict: dict, shared, batch) -> dict:
    """FVTAModel's loss (mean NLL of the label, no dropout) with its attention
    context-parallel over the ranks: logits, loss and every gradient."""
    model = FVTAModel(cfg)
    model.load_state_dict(state_dict)
    from fvta_memexqa_torch.data.device_prepro import assemble

    mi = assemble(shared, batch)
    out = model(shared, mi, cp_attention=make_cp_attention(cfg.model.similarity))
    logp = torch.log_softmax(out.logits, -1)
    loss = -torch.gather(logp, 1, mi.label.long()[:, None]).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True)
    return {"logits": out.logits.detach(), "loss": float(loss),
            "grads": {n: g for n, g in zip(names, grads) if g is not None},
            "same": _same_on_every_rank(_flat([g for g in grads if g is not None]))}


def rank_fails(rank_that_fails: int) -> None:
    """Raises ValueError on one rank after the group formed."""
    mesh.barrier()
    if mesh.dist.get_rank() == rank_that_fails:
        raise ValueError(f"rank {rank_that_fails} fails")
    mesh.barrier()


def rank_hangs() -> None:
    """Rank 1 waits at a barrier that rank 0 never reaches."""
    if mesh.dist.get_rank() == 1:
        mesh.barrier()
    else:
        import time

        time.sleep(3600)


def cp_video_dump(out_dir: str, path: str) -> int:
    """train_video.dump_video_attention of a video run directory's best model
    on its pack's test split, with the attention context-parallel over the
    ranks; each rank writes `path`.<rank>.npz."""
    from fvta_memexqa_torch.convert import load_video_rundir
    from fvta_memexqa_torch.data.video_pack import (VideoDataset, load_video_meta,
                                                    video_shared_tables)
    from fvta_memexqa_torch.train_video import dump_video_attention

    cfg, run, model = load_video_rundir(out_dir, "cpu")
    dcfg, _, shared_np = load_video_meta(run["pack_dir"])
    shared = video_shared_tables(dcfg, shared_np)
    ds = VideoDataset(run["pack_dir"], "test")
    return dump_video_attention(model, shared, ds, 4, f"{path}.{mesh.dist.get_rank()}.npz",
                                cp_attention=make_cp_attention(cfg.model.similarity))
