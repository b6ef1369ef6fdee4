"""Control-plane decision records — the twin of
``pdnlp_tpu/obs/decision.py`` (record schema, IDs and chain rules
unchanged): every actuation of a serving knob is a tiny chain of
zero-duration ``Tracer.mark`` records named ``"decision"`` under one
``decision_id`` (``d<pid>-<n>``): one ``action`` (``knob``, ``old`` ->
``new``, flattened ``cause_*`` attrs) and one ``outcome`` (``result``
``kept`` | ``reverted`` | ``degraded`` ...).

The serving controller (``serve.controller.ServeController``) records
one per knob turn; the decoder records one when a drafter dies and its
pair degrades to plain decode (``draft_k`` forced to 0).
:func:`format_decisions` is ``python -m pdnlp_tpu_torch.tools.trace
decisions``'s table.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence

#: the span-record name every decision record carries
DECISION = "decision"

#: valid values of the ``phase`` attr
PHASES = ("action", "outcome")

_counter = itertools.count(1)
_pid_prefix: Optional[str] = None


def mint_decision_id() -> str:
    """Process-unique decision ID (``d<pid>-<n>``) — same scheme as the
    request IDs, so a merged multi-rank trace keeps them joinable and
    distinct."""
    global _pid_prefix
    if _pid_prefix is None:
        _pid_prefix = f"d{os.getpid()}-"
    return _pid_prefix + str(next(_counter))


def record_decision(tracer, decision_id: str, phase: str, **attrs) -> None:
    """One decision-lifecycle record (``Tracer.mark`` fast lane; no-op on
    a disabled tracer).  ``cause`` dicts are flattened into ``cause_<k>``
    attrs so the record stays a flat JSON line."""
    if not tracer.enabled:
        return
    cause = attrs.pop("cause", None)
    if cause:
        for k, v in cause.items():
            attrs[f"cause_{k}"] = v
    attrs["decision_id"] = decision_id
    attrs["phase"] = phase
    tracer.mark(DECISION, attrs)


# ------------------------------------------------------- reconstruction

def decision_chains(records: Sequence[Dict]) -> Dict[str, List[Dict]]:
    """Every decision's record chain from a span stream, keyed by
    decision ID, each chain time-ordered."""
    by_id: Dict[str, List[Dict]] = {}
    for r in records:
        if r.get("name") != DECISION:
            continue
        did = (r.get("attrs") or {}).get("decision_id")
        if did is not None:
            by_id.setdefault(did, []).append(r)
    for chain in by_id.values():
        chain.sort(key=lambda r: float(r.get("t0", 0.0)))
    return by_id


def decision_issues(chain: Sequence[Dict]) -> List[str]:
    """Integrity violations of one decision chain (empty = complete):
    exactly one ``action`` first, exactly one ``outcome`` last."""
    issues: List[str] = []
    if not chain:
        return ["empty chain"]
    phases = [(r.get("attrs") or {}).get("phase") for r in chain]
    if phases[0] != "action":
        issues.append(f"first record is {phases[0]!r}, not 'action'")
    actions = phases.count("action")
    outcomes = phases.count("outcome")
    if actions != 1:
        issues.append(f"{actions} action records (expected exactly 1)")
    if outcomes == 0:
        issues.append("action without outcome (the controller never "
                      "evaluated this actuation)")
    elif outcomes > 1:
        issues.append(f"{outcomes} outcome records (duplicate evaluation)")
    elif phases[-1] != "outcome":
        issues.append(f"last record is {phases[-1]!r}, not 'outcome'")
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        issues.append(f"unknown phase(s) {unknown}")
    return issues


def validate_decisions(records: Sequence[Dict]) -> Dict:
    """Chain-integrity report over a span stream — the ``bench.py
    --replay`` gate's input: every actuation must carry a complete
    cause -> action -> outcome chain, and the revert count is how many
    actuations the controller judged harmful and undid."""
    by_id = decision_chains(records)
    report: Dict = {"checked": len(by_id), "complete": 0,
                    "incomplete": {}, "reverted": 0, "kept": 0,
                    "by_knob": {}}
    for did in sorted(by_id):
        chain = by_id[did]
        issues = decision_issues(chain)
        if issues:
            report["incomplete"][did] = issues
        else:
            report["complete"] += 1
        attrs = [dict(r.get("attrs") or {}) for r in chain]
        action = next((a for a in attrs if a.get("phase") == "action"), {})
        outcome = next((a for a in attrs if a.get("phase") == "outcome"),
                       {})
        knob = action.get("knob")
        if knob is not None:
            report["by_knob"][knob] = report["by_knob"].get(knob, 0) + 1
        if outcome.get("result") == "reverted":
            report["reverted"] += 1
        elif outcome.get("result") == "kept":
            report["kept"] += 1
    return report


def format_decisions(records: Sequence[Dict]) -> str:
    """The ``tools.trace decisions`` table: one line per decision —
    cause -> action (knob old -> new) -> outcome with its
    evaluation-window delta — followed by the integrity verdict."""
    by_id = decision_chains(records)
    if not by_id:
        return "no decision records found"
    ordered = sorted(by_id.items(),
                     key=lambda kv: float(kv[1][0].get("t0", 0.0)))
    t_first = float(ordered[0][1][0].get("t0", 0.0))
    header = (f"{'t+s':>8} {'knob':<16} {'old':>10} {'new':>10} "
              f"{'outcome':<9} {'delta':>8}  cause")
    lines = [f"{len(ordered)} decision(s)", header, "-" * len(header)]
    bad = 0
    for did, chain in ordered:
        attrs = [dict(r.get("attrs") or {}) for r in chain]
        action = next((a for a in attrs if a.get("phase") == "action"), {})
        outcome = next((a for a in attrs if a.get("phase") == "outcome"),
                       {})
        issues = decision_issues(chain)
        if issues:
            bad += 1
        t = float(chain[0].get("t0", 0.0)) - t_first

        def num(v):
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return str(v)
            return f"{v:.4g}"

        delta = outcome.get("delta_ratio")
        cause = "  ".join(
            f"{k[len('cause_'):]}={num(v)}"
            for k, v in sorted(action.items()) if k.startswith("cause_"))
        revert_of = action.get("revert_of")
        if revert_of:
            cause = f"revert_of={revert_of}  " + cause
        lines.append(
            f"{t:>8.3f} {str(action.get('knob')):<16} "
            f"{num(action.get('old')):>10} {num(action.get('new')):>10} "
            f"{str(outcome.get('result', 'MISSING')):<9} "
            f"{f'{delta:+.1%}' if isinstance(delta, (int, float)) else 'n/a':>8}"
            f"  {cause}")
        if issues:
            lines.append(f"         ^ INCOMPLETE ({did}): "
                         + "; ".join(issues))
    lines.append(f"chains: {len(ordered) - bad}/{len(ordered)} complete")
    return "\n".join(lines)
