"""The comparison that decides ``correct``.

Set-up drives the program through its first captured group of K steps on
the window's own call and feed; right after it the run keeps the
program's outputs: each step's loss, and per parameter (leaf) the norm of
AdamW's first moment and of the change from the starting weights.  Once
the window has closed and the program's state is freed, the reference
(``gpubench.reference``) works the same K steps out again from the raw
corpus, the seeded weights and the dropout seed, and these numbers are
compared, each against its limit (``gpubench/limits/<cell>.json``):

- ``batches``: elements that differ from the reference's derivation, of
  the K batches, of the first epoch's leftover steps (the eager path)
  and of the second epoch's first group (its order), the last two kept
  as the window fed them (exact: limit 0);
- ``tokens``: real tokens of the window by the pipeline's counter against
  the reference's derivation of the same steps (exact: limit 0);
- ``loss_gap``: the largest relative gap of a step's loss;
- ``moment_gap``: the worst leaf's gap between the two norms of AdamW's
  first moment, over the larger of the reference leaf's norm and the
  median leaf's;
- ``change_gap``: the same for the change of the weights;
- ``moment_diff``, ``moment_diff_median``, ``change_diff_median``: the
  norm of the difference in place of the difference of the norms (first
  order in rounding errors, where a gap of norms is second order);
- ``routing_gap`` (a mixture of experts): the reference follows the
  program's routing, ranked from the gate logits the program's K steps
  computed, and this is the widest shortfall of an expert so chosen below
  the reference's own k-th best probability, over every routed token of
  every layer and step.  With the routing held, the numbers above see
  the experts' and the gate's arithmetic rather than near-tied choices
  that flip; a wrong choice reads here, a wrong expert or slot above.

A cell's limits file names the numbers it compares; the others are
printed earlier, for information.

Leaves whose reference first moment is under a thousandth of the median
leaf's (their gradient is nought to rounding, as a key's bias is under
softmax) are left out of the two leaf numbers.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

#: leaves under this share of the median leaf's first moment are left out
NEGLIGIBLE = 1e-3


def leaf_norms(params: Dict[str, torch.Tensor],
               start: Dict[str, torch.Tensor],
               moments: Dict[str, torch.Tensor], keep: Optional[str] = None):
    """``{name: [|first moment|, |change|]}`` in float64; with ``keep``
    (a device) also ``{name: (first moment, change)}`` as float32 tensors
    on that device."""
    out, kept = {}, {}
    with torch.no_grad():
        for n, p in params.items():
            m = moments[n].detach().float()
            d = p.detach().float() - start[n].float()
            out[n] = [m.double().norm().item(), d.double().norm().item()]
            if keep is not None:
                kept[n] = (m.to(keep, copy=True), d.to(keep, copy=True))
    return (out, kept) if keep is not None else out


def worst_leaf(prog: Dict[str, List[float]], ref: Dict[str, List[float]],
               i: int) -> float:
    """The worst leaf's gap of norm ``i`` (0: moment, 1: change)."""
    return leaf_gaps(prog, ref, i)[0][1]


def leaf_gaps(prog: Dict[str, List[float]], ref: Dict[str, List[float]],
              i: int) -> List[tuple]:
    """``(name, gap, program's norm, reference's norm)`` of norm ``i`` for
    every leaf that counts, worst first."""
    names = sorted(ref)
    m_ref = np.asarray([ref[n][0] for n in names])
    keep = m_ref >= NEGLIGIBLE * np.median(m_ref)
    r = np.asarray([ref[n][i] for n in names])
    p = np.asarray([prog[n][i] for n in names])
    denom = np.maximum(r, np.median(r))
    gaps = np.abs(p - r) / np.where(denom > 0, denom, 1.0)
    rows = [(n, float(g), float(a), float(b))
            for n, g, a, b, k in zip(names, gaps, p, r, keep) if k]
    return sorted(rows, key=lambda row: -row[1])


def diff_gaps(prog: Dict[str, tuple], ref: Dict[str, tuple],
              ref_leaves: Dict[str, List[float]], i: int) -> List[tuple]:
    """``(name, |program - reference| / max(|reference|, median leaf's))``
    of tensor ``i`` (0: moment, 1: change) for every leaf that counts,
    worst first: the norm of the difference, where :func:`leaf_gaps`
    takes the difference of the norms."""
    names = sorted(ref_leaves)
    m_ref = np.asarray([ref_leaves[n][0] for n in names])
    keep = m_ref >= NEGLIGIBLE * np.median(m_ref)
    r = np.asarray([ref_leaves[n][i] for n in names])
    med = np.median(r)
    rows = []
    with torch.no_grad():
        for n, k, rn in zip(names, keep, r):
            if not k:
                continue
            want = ref[n][i]
            have = prog[n][i].to(want.device)
            d = (have.double() - want.double()).norm().item()
            rows.append((n, d / max(rn, med, 1e-30)))
    return sorted(rows, key=lambda row: -row[1])


def loss_gap(prog: List[float], ref: List[float]) -> float:
    p, r = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(p - r) / np.abs(r)).max())


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared (module docstring) from the program's and the
    reference's readings: ``losses`` and ``leaves`` each, plus the
    program's ``batches`` and ``tokens`` mismatches."""
    out = {"batches": float(prog.get("batches_diff", 0)),
           "tokens": float(prog.get("tokens_diff", 0)),
           "loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "moment_gap": worst_leaf(prog["leaves"], ref["leaves"], 0),
           "change_gap": worst_leaf(prog["leaves"], ref["leaves"], 1)}
    if "tensors" in prog and "tensors" in ref:
        m, d = ([x[1] for x in diff_gaps(prog["tensors"], ref["tensors"],
                                          ref["leaves"], i)] for i in (0, 1))
        out["moment_diff"] = float(m[0])
        out["moment_diff_median"] = float(np.median(m))
        out["change_diff_median"] = float(np.median(d))
    if "routing_gap" in ref:
        out["routing_gap"] = float(ref["routing_gap"])
    return out


def batches_diff(prog: Dict[str, np.ndarray],
                 ref: List[Dict[str, np.ndarray]]) -> int:
    """Elements of the program's ``[K, rows, ...]`` group that differ from
    the reference's K batches, channel by channel; a channel missing on
    either side counts whole."""
    diff = 0
    for key in ("input_ids", "segment_ids", "position_ids",
                "attention_mask", "token_type_ids", "cls_positions",
                "label", "example_weight"):
        want = np.stack([b[key] for b in ref])
        have = prog.get(key)
        if have is None or have.shape != want.shape:
            diff += want.size
            continue
        diff += int((have.astype(np.float64) != want.astype(np.float64))
                    .sum())
    return diff


def judge(numbers: Dict[str, float], limits: Dict
          ) -> Dict[str, Dict[str, Optional[float]]]:
    """``{name: {"value", "limit"}}`` for every number the cell's limits
    file names (its ``numbers``); a limit on a number that is not
    computed is refused."""
    out = {}
    for name, lim in limits["numbers"].items():
        if name not in numbers:
            raise KeyError(f"a limit is set on {name!r}, which is not "
                           "computed")
        out[name] = {"value": numbers[name], "limit": lim["limit"]}
    return out


def passed(judged: Dict[str, Dict]) -> bool:
    return all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in judged.values())
