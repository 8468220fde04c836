"""data/device_prepro.stage_to: a batch's move to the card through a per-device
ring of two reused pinned host slots, with copies that do not block the host.

On the CPU: a CPU target keeps the plain `.to`; the per-field decision
(`staged_keys`); the slot layout's alignment; the ring's rotation, growth,
waits and counters with a stand-in event; the ring under many threads.

On the card (skipped without one), at the benchmark cells' shapes: `Batch` and
`VideoInputs` equal to the plain `.to` bit for bit; host tensors overwritten
right after the call; back-to-back calls reusing the ring; the prefetch
worker's batches; a slot grown by a larger batch; no pinned allocation after a
ring's first two calls; device-resident fields passed through:

    python -m pytest tests/test_torch_staging.py -m gpu --noconftest -q
"""

import sys
import threading

import pytest
import torch

from fvta_memexqa_torch import train as tr
from fvta_memexqa_torch.data import device_prepro as dp
from fvta_memexqa_torch.data.device_prepro import (STAGE_ALIGN, STAGE_SLOTS, Batch,
                                                   StagingRing, slot_layout, stage_to,
                                                   staged_keys)
from fvta_memexqa_torch.data.stream import Prefetcher
from fvta_memexqa_torch.models.video import VideoInputs

# (N, Jq, W, Ja, A): memexqa-train-b256 / memexqa-eval-b256
MEMEXQA_B256 = (256, 30, 16, 8, 4)
# (N, T, F, Jq, W, C, Ja): tvqa-frames-train-b128
TVQA_B128 = (128, 270, 2048, 25, 16, 5, 15)


def memexqa_batch(seed: int, shape=MEMEXQA_B256) -> Batch:
    """A host Batch of fresh tensors, every field seeded."""
    n, jq, w, ja, a = shape
    g = torch.Generator().manual_seed(seed)
    ints = lambda *s: torch.randint(0, 12000, s, generator=g, dtype=torch.int32)
    bools = lambda *s: torch.rand(s, generator=g) < 0.5
    return Batch(q_words=ints(n, jq), q_chars=ints(n, jq, w), q_mask=bools(n, jq),
                 choice_words=ints(n, 4, ja), choice_chars=ints(n, 4, ja, w),
                 choice_mask=bools(n, 4, ja), album_idx=ints(n, a), album_mask=bools(n, a),
                 label=ints(n), ex_mask=bools(n))


def video_inputs(seed: int, shape=TVQA_B128) -> VideoInputs:
    """Host VideoInputs of fresh tensors, every field seeded."""
    n, t, f, jq, w, c, ja = shape
    g = torch.Generator().manual_seed(seed)
    ints = lambda *s: torch.randint(0, 20000, s, generator=g, dtype=torch.int32)
    bools = lambda *s: torch.rand(s, generator=g) < 0.5
    return VideoInputs(frame_feats=torch.rand((n, t, f), generator=g), frame_mask=bools(n, t),
                       q_words=ints(n, jq), q_chars=ints(n, jq, w), q_mask=bools(n, jq),
                       choice_words=ints(n, c, ja), choice_chars=ints(n, c, ja, w),
                       choice_mask=bools(n, c, ja), label=ints(n), ex_mask=bools(n))


SMALL = {"memexqa": lambda seed: memexqa_batch(seed, (6, 5, 4, 3, 2)),
         "video": lambda seed: video_inputs(seed, (3, 7, 5, 4, 3, 5, 2))}


def counters() -> tuple:
    return stage_to.batches, stage_to.bytes, stage_to.waits


class StandInEvent:
    """torch.cuda.Event's surface: `done` says whether the recorded work has
    finished; synchronize() finishes it."""

    def __init__(self):
        self.done, self.records, self.syncs = True, 0, 0

    def record(self):
        self.records += 1

    def query(self):
        return self.done

    def synchronize(self):
        self.syncs += 1
        self.done = True


def cpu_ring(allocs: list | None = None) -> StagingRing:
    """A ring of plain host slots and stand-in events; allocs collects each
    slot's size as it is allocated."""
    def alloc(n):
        if allocs is not None:
            allocs.append(n)
        return torch.empty(n, dtype=torch.uint8)
    return StagingRing(alloc, StandInEvent)


def fields_of(batch) -> dict:
    return dict(batch.__dict__)


def slot_of(ring: StagingRing, t: torch.Tensor) -> int:
    """The slot a staged view lies in."""
    for i, s in enumerate(ring.slots):
        if s is not None and s.data_ptr() <= t.data_ptr() < s.data_ptr() + s.numel():
            return i
    raise AssertionError("the view lies in no slot")


# ---- CPU ----------------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(SMALL))
def test_cpu_target_keeps_the_plain_to(kind):
    """.to("cpu") returns each host tensor as the plain .to does (itself) and
    stages nothing."""
    x = SMALL[kind](0)
    before = counters()
    y = x.to("cpu")
    assert type(y) is type(x)
    for k, t in x.__dict__.items():
        assert getattr(y, k) is t, k
    assert counters() == before


@pytest.mark.parametrize("target, where, want", [
    ("cuda", ("cpu", "cpu"), ["a", "b"]),
    ("cuda:0", ("cpu", "cpu"), ["a", "b"]),
    ("cuda", ("meta", "cpu"), ["b"]),       # a field already on a device is not staged
    ("cuda", ("meta", "meta"), []),
    ("cpu", ("cpu", "cpu"), []),             # a CPU target: the plain .to
    ("meta", ("cpu", "cpu"), []),
])
def test_staged_keys_decide_per_field(target, where, want):
    fields = {k: torch.zeros(3, device=d) for k, d in zip("ab", where)}
    assert staged_keys(fields, torch.device(target)) == want


def test_slot_layout_aligns_every_field_without_overlap():
    fields = {"f": torch.zeros(3, 5), "b": torch.zeros(7, dtype=torch.bool),
              "empty": torch.zeros(0, 4, dtype=torch.float64), "s": torch.tensor(1.5),
              "i": torch.zeros(2, 600, dtype=torch.int32), "h": torch.zeros(1, dtype=torch.int16)}
    offsets, size = slot_layout(fields)
    assert offsets == [0, 512, 1024, 1024, 1536, 6656]
    assert size == 7168
    spans = sorted((o, o + t.nbytes) for o, t in zip(offsets, fields.values()))
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(o % STAGE_ALIGN == 0 for o in offsets) and size % STAGE_ALIGN == 0
    assert slot_layout({}) == ([], 0)


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_ring_gives_the_fields_bit_for_bit(kind):
    """Values, dtypes and shapes through the ring equal the input's, each view
    aligned in its slot; the caller's later writes do not reach what moved."""
    ring = cpu_ring()
    x = fields_of(SMALL[kind](1))
    want = {k: t.clone() for k, t in x.items()}
    out = ring.stage(x, torch.clone)
    views = ring.stage(x, lambda v: v)
    for k, t in want.items():
        assert out[k].dtype == t.dtype and out[k].shape == t.shape, k
        assert torch.equal(out[k], t), k
        assert (views[k].data_ptr() - ring.slots[1].data_ptr()) % STAGE_ALIGN == 0, k
    for t in x.values():
        t.zero_()
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_ring_rotates_over_its_slots_and_reuses_them():
    allocs = []
    ring = cpu_ring(allocs)
    used = [slot_of(ring, ring.stage(fields_of(SMALL["memexqa"](s)), lambda v: v)["q_words"])
            for s in range(5)]
    assert used == [i % STAGE_SLOTS for i in range(5)] == [0, 1, 0, 1, 0]
    assert len(allocs) == STAGE_SLOTS
    assert [e.records for e in ring.events] == [3, 2]


def test_ring_grows_a_slot_to_the_largest_batch_only():
    allocs = []
    ring = cpu_ring(allocs)
    small, large = (fields_of(memexqa_batch(0, s)) for s in ((4, 5, 4, 3, 2), (9, 5, 4, 3, 2)))
    size = lambda f: slot_layout(f)[1]
    ring.stage(small, torch.clone)
    ring.stage(small, torch.clone)
    assert allocs == [size(small)] * 2
    out = ring.stage(large, torch.clone)   # slot 0 grows
    assert allocs[-1] == size(large) and ring.slots[0].numel() == size(large)
    assert all(torch.equal(out[k], large[k]) for k in large)
    for f in (small, small, large, large, small):   # slot 1 grows once; nothing else
        out = ring.stage(f, torch.clone)
        assert all(torch.equal(out[k], f[k]) and out[k].shape == f[k].shape for k in f)
    assert allocs == [size(small)] * 2 + [size(large)] * 2


def test_ring_waits_only_for_a_slot_still_in_flight():
    ring = cpu_ring()
    x = fields_of(SMALL["video"](2))
    before = stage_to.waits
    ring.stage(x, torch.clone)
    ring.stage(x, torch.clone)
    ring.events[0].done = False           # slot 0's copies still in flight
    ring.stage(x, torch.clone)
    assert stage_to.waits == before + 1 and ring.events[0].syncs == 1
    ring.stage(x, torch.clone)            # slot 1's finished: no wait
    assert stage_to.waits == before + 1 and ring.events[1].syncs == 0


def test_counters_count_calls_and_staged_bytes():
    ring = cpu_ring()
    x, y = fields_of(SMALL["memexqa"](3)), fields_of(SMALL["video"](3))
    before = counters()
    ring.stage(x, torch.clone)
    ring.stage(y, torch.clone)
    nbytes = sum(t.nbytes for f in (x, y) for t in f.values())
    assert counters() == (before[0] + 2, before[1] + nbytes, before[2])


def test_ring_under_many_threads_keeps_every_batch_whole():
    """24 threads stage their own batches through one ring with a short
    switch interval: every result equals its batch, and the counters add up."""
    ring = cpu_ring()
    threads, per = 24, 8
    bad, errors = [], []
    before = counters()

    def work(tid):
        try:
            for i in range(per):
                x = fields_of(SMALL["memexqa"](tid * per + i))
                out = ring.stage(x, torch.clone)
                if not all(torch.equal(out[k], x[k]) for k in x):
                    bad.append((tid, i))
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert not errors and not bad
    assert stage_to.batches == before[0] + threads * per


# ---- the card -------------------------------------------------------------------------------

@pytest.fixture
def cuda(monkeypatch):
    """The card, with fresh staging rings (so allocation counts start at 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(dp, "_RINGS", {})
    return torch.device("cuda")


def plain_to(x, device):
    return type(x)(**{k: t.to(device) for k, t in x.__dict__.items()})


def assert_same(got, want):
    for k, w in want.__dict__.items():
        g = getattr(got, k)
        assert g.device == w.device and g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def whole_batch(make):
    return {"memexqa": memexqa_batch, "video": video_inputs}[make]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["memexqa", "video"])
def test_staged_equals_plain_to_at_the_cells_shapes(cuda, kind):
    x = whole_batch(kind)(11)
    before = counters()
    got = x.to(cuda)
    assert_same(got, plain_to(x, cuda))
    ptrs = [t.untyped_storage().data_ptr() for t in got.__dict__.values()]
    assert len(set(ptrs)) == len(ptrs)   # each field an allocation of its own
    nbytes = sum(t.nbytes for t in x.__dict__.values())
    assert counters()[:2] == (before[0] + 1, before[1] + nbytes)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["memexqa", "video"])
def test_host_overwritten_after_the_call_leaves_the_card_intact(cuda, kind):
    x = whole_batch(kind)(12)
    want = plain_to(x, cuda)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)   # the copies queue behind ~0.5 s of device work
    got = x.to(cuda)
    for t in x.__dict__.values():
        t.fill_(1)
    assert_same(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["memexqa", "video"])
def test_back_to_back_calls_without_a_sync_each_arrive_whole(cuda, kind):
    xs = [whole_batch(kind)(20 + i) for i in range(3)]
    wants = [plain_to(x, cuda) for x in xs]
    xs[0].to(cuda)
    xs[1].to(cuda)                     # both slots allocated
    torch.cuda.synchronize()
    before = stage_to.waits
    torch.cuda._sleep(1_000_000_000)   # slot 0's copies still queued at the third call
    gots = [x.to(cuda) for x in xs]
    assert stage_to.waits == before + 1
    for got, want in zip(gots, wants):
        assert_same(got, want)


@pytest.mark.gpu
def test_prefetch_workers_deliver_the_inline_batches(cuda):
    """train.on_device at prefetch 2 (`cli train --prefetch`) and train_video's
    Prefetcher give the batches of the inline path."""
    batches = [memexqa_batch(30 + i) for i in range(5)]
    with tr.on_device(iter(batches), lambda b: b.to(cuda), 0) as it:
        inline = list(it)
    with tr.on_device(iter(batches), lambda b: b.to(cuda), 2) as it:
        fetched = list(it)
    for got, want in zip(fetched, inline, strict=True):
        assert_same(got, want)
    vis = [video_inputs(40 + i, (16, 270, 2048, 25, 16, 5, 15)) for i in range(4)]
    inline = [v.to(cuda) for v in vis]
    with Prefetcher(iter(vis), depth=2, transfer=lambda v: v.to(cuda)) as it:
        fetched = list(it)
    for got, want in zip(fetched, inline, strict=True):
        assert_same(got, want)


@pytest.mark.gpu
def test_a_larger_batch_grows_its_slot(cuda):
    small, large = memexqa_batch(50, (64, 30, 16, 8, 4)), memexqa_batch(51)
    small.to(cuda)
    small.to(cuda)
    ring = dp._RINGS[torch.device("cuda", torch.cuda.current_device())]
    sizes = [s.numel() for s in ring.slots]
    got = large.to(cuda)
    assert ring.slots[0].numel() == slot_layout(large.__dict__)[1] > sizes[0]
    assert ring.slots[1].numel() == sizes[1]
    assert_same(got, plain_to(large, cuda))


@pytest.mark.gpu
def test_no_pinned_allocation_after_the_first_two_calls(cuda):
    xs = [video_inputs(60 + i, (32, 270, 2048, 25, 16, 5, 15)) for i in range(2)]
    xs[0].to(cuda)
    xs[1].to(cuda)
    ring = dp._RINGS[torch.device("cuda", torch.cuda.current_device())]
    ptrs = [s.data_ptr() for s in ring.slots]
    assert all(s.is_pinned() for s in ring.slots)
    stats = torch.cuda.host_memory_stats()
    for i in range(6):
        got = xs[i % 2].to(cuda)
    assert_same(got, plain_to(xs[1], cuda))
    assert [s.data_ptr() for s in ring.slots] == ptrs
    after = torch.cuda.host_memory_stats()
    assert after.get("num_host_alloc") == stats.get("num_host_alloc")


@pytest.mark.gpu
def test_device_resident_fields_pass_through(cuda):
    x = memexqa_batch(70)
    on_card = plain_to(x, cuda)
    before = counters()
    again = on_card.to(cuda)
    assert all(getattr(again, k) is t for k, t in on_card.__dict__.items())
    assert counters() == before
    mixed = dict(on_card.__dict__, q_chars=x.q_chars, label=x.label)
    got = stage_to(mixed, cuda)
    assert all(got[k] is t for k, t in on_card.__dict__.items() if k not in ("q_chars", "label"))
    assert torch.equal(got["q_chars"], on_card.q_chars) and torch.equal(got["label"], on_card.label)
    assert counters()[:2] == (before[0] + 1, before[1] + x.q_chars.nbytes + x.label.nbytes)


def test_card_helpers_make_what_the_card_tests_compare():
    """The card tests' host batches are seeded and of the cells' shapes."""
    a, b = memexqa_batch(1), memexqa_batch(1)
    assert_same(a, b)
    assert a.choice_chars.shape == (256, 4, 8, 16) and a.label.dtype == torch.int32
    v = video_inputs(2, (2, 270, 2048, 25, 16, 5, 15))
    assert v.frame_feats.shape == (2, 270, 2048) and v.frame_mask.dtype == torch.bool
