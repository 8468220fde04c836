"""The numbers that decide `correct`, each later held against its limit.

Training (the first three steps of the object the window drives):
- `loss_gap`: the largest of the three steps' |loss - ref| / |ref|;
- `grad_gap`: the first gradient as the optimizer got it, by the worst leaf:
  | |g| - |g_ref| | over the larger of |g_ref| and the median leaf's |g_ref|;
- `change_gap`: the parameters' change over the three steps, by the worst
  leaf, measured as grad_gap is. Leaves and entries whose reference gradient
  is nought to rounding in all three steps move under Adam by round-off alone
  and are left out: the rule reads each entry's largest |gradient| over the
  three steps, and leaves out a leaf whose norm of those is under a
  thousandth of the median leaf's, and in the others an entry under a
  thousandth of the median leaf's root-mean-square. Under the softmax over
  choices these are the scorer's bias and its weights of the context and the
  attended question, which every choice of an example shares. An entry that a
  later step first touches (an embedding row absent from the first batch) is
  kept.
The gaps are between norms, not norms of differences. A gradient of the
right norm in a wrong direction moves the parameters elsewhere, which the
losses of steps 2 and 3 read.

Evaluation (whole checkpoint evaluations at the window's sizes):
- `cache_gap`: the largest |h - h_ref| over the last evaluation's album cache
  (inf where a mask differs or a shape does);
- `logit_gap`: the largest |logit - ref| over every question of every
  evaluation the run made.
The evaluations' mean loss and accuracy are not compared: the control's
logit errors (~3e-5) do not move the mean of 4096 losses past its rounding,
and accuracy moves only where two choices tie to within those errors, which
sound runs meet too (PERF.md).

A number that is not finite reads inf.
"""

from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3   # an entry whose reference gradient is under this share of the median leaf's


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _norms(tensors: dict) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _gap(pn: dict, rn: dict, leaves) -> float:
    """The worst leaf's | |prog| - |ref| | over the larger of |ref| and the
    median leaf's |ref|."""
    med = statistics.median(rn[n] for n in leaves)
    return _finite(max(abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in leaves))


def kept_entries(grad_ref: dict) -> dict[str, torch.Tensor]:
    """Per leaf, the entries whose reference gradient (each entry's largest
    |gradient| over the compared steps) is not nought to rounding: leaves whose
    norm of it is at least NOUGHT x the median leaf's, and in them the entries
    of at least NOUGHT x the median leaf's root-mean-square."""
    norms = _norms(grad_ref)
    leaf_floor = NOUGHT * statistics.median(norms.values())
    rms = {n: norms[n] / math.sqrt(max(g.numel(), 1)) for n, g in grad_ref.items()}
    floor = NOUGHT * statistics.median(rms.values())
    return {n: g.abs() >= floor for n, g in grad_ref.items() if norms[n] >= leaf_floor}


def _change_norms(delta: dict, kept: dict) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(delta[n][k].double())) for n, k in kept.items()}


def _numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, the leaf behind each). prog / ref: {"losses": [3 floats],
    "grad1": {leaf: tensor}, "delta3": {leaf: tensor}}; ref also "grad_max"."""
    if set(prog["grad1"]) != set(ref["grad1"]) or len(prog["losses"]) != len(ref["losses"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}, {}
    loss_gap = _finite(max(abs(a - b) / max(abs(b), 1e-30)
                           for a, b in zip(prog["losses"], ref["losses"])))
    pg, rg = _norms(prog["grad1"]), _norms(ref["grad1"])
    kept = {n: k for n, k in kept_entries(ref["grad_max"]).items() if bool(k.any())}
    pc, rc = _change_norms(prog["delta3"], kept), _change_norms(ref["delta3"], kept)
    numbers = {"loss_gap": loss_gap, "grad_gap": _gap(pg, rg, list(rg)),
               "change_gap": _gap(pc, rc, list(kept))}
    worst = {}
    for key, pn, rn in (("grad_gap", pg, rg), ("change_gap", pc, rc)):
        med = statistics.median(rn.values())
        worst[key] = max(rn, key=lambda n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30))
    return numbers, worst


def eval_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """prog: {"cache_h", "cache_m" (the last evaluation's album cache),
    "logits" [E, Q, C] (every evaluation's)}; ref: the same, one evaluation."""
    def gap(a, b):
        if a is None or a.shape[-b.dim():] != b.shape:
            return math.inf
        return _finite(float((a.double() - b.double()).abs().max()))

    cache_gap = gap(prog["cache_h"], ref["cache_h"])
    if prog["cache_m"] is None or prog["cache_m"].shape != ref["cache_m"].shape or bool(
            (prog["cache_m"] != ref["cache_m"]).any()):
        cache_gap = math.inf
    return {"cache_gap": cache_gap, "logit_gap": gap(prog["logits"], ref["logits"])}
