"""Ranks over torch.distributed: the port's counterpart of the JAX package's
parallel/mesh.py.

The JAX package runs one process over a ("data", "ctx") device mesh and XLA
emits the collectives. The port runs one process per rank:

- `make_mesh(cfg, devices)` lays the ranks out: world = data_parallel x
  context_parallel, rank r at (data, ctx) = divmod(r, context_parallel), on
  devices[r]. By default one rank per card (or any number of CPU ranks); an
  explicit `devices` list may repeat a card, so 2 or 4 ranks can share one.
- `run_ranks(fn, layout, *args)` spawns the ranks, joins them into a process
  group through a FileStore in a temporary directory (no TCP port), runs
  `fn(*args)` in each and returns rank 0's result with its tensors on the CPU.
  A rank that fails or outlives the timeout fails the launch: the others are
  killed and the child's exception is raised here.
- `launches_ranks(mesh_of)` is how an entry point (train, test,
  test_ensemble, train_video, the video CLI's plain loop) becomes ranks:
  outside a process group it runs itself on every rank through run_ranks;
  inside one each process finds its place with `current_rank`.
- `maybe_initialize_distributed()` joins a group from torchrun's environment
  instead, on one host or several (rank r on card LOCAL_RANK of its host);
  the entry points then run their part on this rank.
- Backend: nccl when every rank has a card of its own, gloo when ranks share
  a card (NCCL refuses two ranks on one device) or run on the CPU.

Every reduction here is an all-gather (or, where each rank needs only its
own slice, an all-to-all: sum_scatter) followed by a sum in rank order, so
every rank holds the same bits whatever algorithm the backend uses (an
all-reduce gives no such guarantee), with no float atomics. The autograd
Functions are the conjugate pairs the parallel paths need: a gather whose
backward hands each rank its own slice, an identity whose backward sums
across ranks, and the slice / gather pairs of a sharded axis.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import inspect
import os
import pickle
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from fvta_memexqa_torch.config import MeshConfig

RANK_TIMEOUT_S = 1800.0   # run_ranks: the whole launch, rendezvous included
_RESULT, _ERROR = "result.pt", "error-{}.pkl"


@dataclass(frozen=True)
class RankLayout:
    """data_parallel x context_parallel ranks; rank r runs on devices[r]."""

    data_parallel: int
    context_parallel: int
    devices: tuple[str, ...]

    @property
    def world(self) -> int:
        return self.data_parallel * self.context_parallel

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data_parallel, "ctx": self.context_parallel}

    def coords(self, rank: int) -> tuple[int, int]:
        """(data, ctx) of a rank: the JAX mesh's reshape(data, ctx) order."""
        return divmod(rank, self.context_parallel)

    def device(self, rank: int) -> torch.device:
        return torch.device(self.devices[rank])

    @property
    def backend(self) -> str:
        devs = [torch.device(d) for d in self.devices]
        if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
            return "nccl"
        return "gloo"


def _normalize(device) -> str:
    d = torch.device(device)
    return "cuda:0" if d.type == "cuda" and d.index is None else str(d)


def make_mesh(cfg: MeshConfig, devices: list | None = None, device="cuda") -> RankLayout:
    """The rank layout of cfg. devices=None: one rank per card for a CUDA
    `device` (ValueError when there are fewer cards than ranks), or every rank
    on the CPU. An explicit list is honored as given, repeated entries included."""
    need = cfg.data_parallel * cfg.context_parallel
    if devices is None:
        if torch.device(device).type == "cpu":
            devices = ["cpu"] * need
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if len(devices) < need:
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    return RankLayout(cfg.data_parallel, cfg.context_parallel,
                      tuple(_normalize(d) for d in devices[:need]))


@dataclass(frozen=True)
class Rank:
    """This process's place in a layout."""

    layout: RankLayout
    rank: int

    @property
    def data(self) -> int:
        return self.layout.coords(self.rank)[0]

    @property
    def ctx(self) -> int:
        return self.layout.coords(self.rank)[1]

    @property
    def device(self) -> torch.device:
        return self.layout.device(self.rank)

    @property
    def is_first(self) -> bool:
        return self.rank == 0

    def data_group(self):
        """The group of this rank's data ranks (its ctx column): the whole
        world (None) when context_parallel is 1. Every rank creates every
        column's group, in the same order, at the first call."""
        dp, cp = self.layout.data_parallel, self.layout.context_parallel
        if cp == 1:
            return None
        if self.layout not in _DATA_GROUPS:
            _DATA_GROUPS[self.layout] = [dist.new_group([d * cp + c for d in range(dp)])
                                         for c in range(cp)]
        return _DATA_GROUPS[self.layout][self.ctx]


_DATA_GROUPS: dict[RankLayout, list] = {}


def maybe_initialize_distributed() -> bool:
    """Join a process group from torchrun's environment (MASTER_ADDR,
    WORLD_SIZE, RANK): the counterpart of the JAX package's multi-host
    entry. Without that environment, or inside a group already, nothing
    happens. Returns True if this call initialized the group."""
    if dist.is_initialized() or not all(
            os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        return False
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    backend = "gloo"
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local % cards)
        backend = "nccl" if per_host <= cards else "gloo"   # nccl: a card per rank
    dist.init_process_group(backend)
    return True


def group_devices(world: int, device="cuda") -> list[str]:
    """Every rank's device in a group that was not launched by run_ranks
    (torchrun's): the CPU for a CPU `device`, else card LOCAL_RANK % cards of
    the rank's own host, torchrun numbering each host's LOCAL_WORLD_SIZE ranks
    contiguously. The world may exceed this host's cards (several hosts, or
    ranks sharing a card)."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * world
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = max(torch.cuda.device_count(), 1)
    return [f"cuda:{(r % per_host) % cards}" for r in range(world)]


def current_rank(cfg: MeshConfig, devices: list | None = None, device="cuda"
                 ) -> Rank | None:
    """This process's Rank when cfg has more than one rank and the process
    runs inside a process group, else None. devices=None: the group's own
    layout (group_devices). The group's world size must be the layout's."""
    if not dist.is_initialized() or cfg.num_devices == 1:
        return None
    world = dist.get_world_size()
    if world != cfg.num_devices:
        raise ValueError(f"the process group has {world} ranks, the mesh "
                         f"{{'data': {cfg.data_parallel}, 'ctx': {cfg.context_parallel}}} "
                         f"needs {cfg.num_devices}")
    layout = make_mesh(cfg, devices if devices is not None else group_devices(world, device))
    return Rank(layout, dist.get_rank())


def in_group() -> bool:
    """True inside a process group (torchrun's, or a rank of run_ranks)."""
    return dist.is_initialized()


def is_first_rank() -> bool:
    """True outside a process group and on rank 0 inside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


# ---- launching the ranks ------------------------------------------------------------

def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.nn.Module):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_cpu(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            object.__setattr__(obj, f.name, _to_cpu(getattr(obj, f.name)))
    return obj


def _write_error(tmp: str, rank: int, e: BaseException) -> None:
    """The rank's exception and the time it was raised, for run_ranks to pick
    the first one: the others are mostly ranks losing their peer."""
    path = os.path.join(tmp, _ERROR.format(rank))
    if os.path.exists(path):
        return
    try:
        blob = pickle.dumps((time.time(), e))
    except Exception:  # noqa: BLE001 - an unpicklable error travels as text
        blob = pickle.dumps((time.time(), RuntimeError(f"rank {rank}: {e!r}")))
    with open(path, "wb") as f:
        f.write(blob)


def _rank_main(rank: int, layout: RankLayout, tmp: str, fn, args) -> None:
    try:
        dev = layout.device(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # one thread per CPU rank: a CPU op's bits can depend on its thread
            # count, and a rank's must not depend on how many ranks share the host
            torch.set_num_threads(1)
        store = dist.FileStore(os.path.join(tmp, "store"), layout.world)
        dist.init_process_group(layout.backend, store=store, rank=rank,
                                world_size=layout.world,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            out = fn(*args)
            if rank == 0:
                torch.save(_to_cpu(out), os.path.join(tmp, _RESULT))
        except BaseException as e:
            _write_error(tmp, rank, e)   # before the group's teardown wakes the peers
            raise
        finally:
            dist.destroy_process_group()
    except BaseException as e:
        _write_error(tmp, rank, e)
        raise


def run_ranks(fn, layout: RankLayout, *args, timeout: float | None = None):
    """Spawn layout.world processes (torch.multiprocessing, "spawn"), each
    joining one process group and calling fn(*args); return rank 0's result
    with its tensors on the CPU. fn and args must pickle. Every rank is
    joined within `timeout` seconds (default RANK_TIMEOUT_S): if one fails
    or the time runs out, the rest are killed and the exception raised first
    in any rank (or a TimeoutError) is raised here."""
    if dist.is_initialized():
        raise RuntimeError("run_ranks must be called outside a process group")
    timeout = RANK_TIMEOUT_S if timeout is None else timeout
    with tempfile.TemporaryDirectory(prefix="fvta_ranks_") as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(layout, tmp, fn, args), nprocs=layout.world,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=min(5.0, max(deadline - time.monotonic(), 0.01))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{layout.world} ranks did not finish within "
                                       f"{timeout:.0f} s")
        except ProcessException as e:
            errors = []
            for r in range(layout.world):
                path = os.path.join(tmp, _ERROR.format(r))
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        errors.append(pickle.load(f))
            if errors:
                raise min(errors, key=lambda te: te[0])[1] from e
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return torch.load(os.path.join(tmp, _RESULT), map_location="cpu",
                          weights_only=False)


def launches_ranks(mesh_of):
    """Decorator: how an entry point that takes `device` and `devices`
    keywords becomes ranks. mesh_of(its arguments by name) checks them and
    returns the MeshConfig. With more than one rank and outside a process
    group, the call runs the entry point on every rank of make_mesh(cfg,
    devices, device) through run_ranks, with the same arguments passed by
    name and devices = the layout's, and returns rank 0's result. Otherwise
    (one rank, or a rank inside a group) the entry point runs here; it finds
    its place with current_rank."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def entry(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            kw = bound.arguments
            cfg = mesh_of(kw)
            if cfg.num_devices == 1 or in_group():
                return fn(**kw)
            layout = make_mesh(cfg, kw["devices"], kw["device"])
            return run_ranks(functools.partial(entry, **{**kw, "devices": list(layout.devices)}),
                             layout)
        return entry
    return wrap


# ---- collectives in rank order ------------------------------------------------------

def all_gather(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's `x` (same shape everywhere), in rank order, on x's device.
    Bool tensors travel as uint8. gloo gathers host tensors only: a CUDA
    tensor under gloo (ranks sharing a card) is staged through the host and
    the parts are moved back; the computation stays on the card."""
    world = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    send = (x.to(torch.uint8) if is_bool else x).contiguous()
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(world)]
    dist.all_gather(parts, send, group=group)
    if staged:
        parts = [p.to(x.device) for p in parts]
    return [p.bool() for p in parts] if is_bool else parts


def rank_sum(parts: list[torch.Tensor]) -> torch.Tensor:
    """((p0 + p1) + p2) + ...: the same order, hence the same bits, everywhere."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def sum_across(x: torch.Tensor, group=None) -> torch.Tensor:
    """The rank-order sum of every rank's x, identical on every rank."""
    return rank_sum(all_gather(x, group))


def sum_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """A reduce-scatter in rank order: x's dim 0 splits into one chunk per
    rank; rank r gets the rank-order sum of every rank's chunk r, receiving
    only those chunks (all_to_all). Bool tensors are OR-ed. gloo's all_to_all
    takes host tensors only: a CUDA tensor under gloo is staged through the
    host, as in all_gather."""
    world = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    send = (x.to(torch.uint8) if is_bool else x).contiguous()
    staged = send.is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    parts = list(recv.chunk(world))
    if is_bool:
        return torch.stack(parts).any(0)
    return rank_sum(parts)


def gather_objects(obj, group=None) -> list:
    """Every rank's picklable `obj`, in rank order (host side)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class GatherStack(torch.autograd.Function):
    """Forward: every rank's x stacked in rank order [world, ...]. The result
    is used the same way on every rank, so its cotangent is the same
    everywhere and the backward hands each rank its own slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        return torch.stack(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class SumBackward(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent across ranks in rank
    order: for a replicated value each rank uses on its own shard."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_across(g.contiguous(), ctx.group), None


class TakeShard(torch.autograd.Function):
    """Forward: this rank's contiguous chunk of a replicated x along `dim`.
    Backward: every rank's chunk cotangent gathered into the full one, so the
    replicated computation upstream gets the same gradient on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group = dim, group
        return x.chunk(world, dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g.contiguous(), ctx.group), ctx.dim), None, None


class GatherShards(torch.autograd.Function):
    """Forward: every rank's x concatenated along dim 0 in rank order. The
    ranks use the result differently, so the backward sums every rank's
    cotangent in rank order and hands each rank the rows it contributed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.rank = dist.get_rank(group)
        return torch.cat(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        parts = [p[lo: lo + ctx.rows] for p in all_gather(g.contiguous(), ctx.group)]
        return rank_sum(parts), None


def take_rows(obj, index: int, count: int):
    """Rows [index * n/count, (index + 1) * n/count) of a tensor or of every
    tensor field of a dataclass (Batch, VideoInputs)."""
    if isinstance(obj, torch.Tensor):
        n = obj.shape[0]
        if n % count:
            raise ValueError(f"{n} rows do not split over {count} data ranks")
        k = n // count
        return obj[index * k:(index + 1) * k]
    return dataclasses.replace(obj, **{
        f.name: take_rows(getattr(obj, f.name), index, count)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})
