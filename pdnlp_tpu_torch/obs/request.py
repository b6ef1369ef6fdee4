"""Per-request distributed tracing: one ID, every hop, one reconstructable
life — the port's copy of ``pdnlp_tpu/obs/request.py`` (jax-free; copied,
never imported), so a serving trace of either package validates with the
same chain contract.

The serve tier moves a request through admission tiers, queues, pack
placements, dispatches, hedges, requeues and ejection re-packs; without a
joinable identity, a request that was admitted on replica 2, stranded by
a mid-storm kill, re-packed onto replica 0 and completed there would leave
three disconnected span streams.

This module is the identity layer:

- :func:`mint_request_id` — a process-unique ``r<pid>-<n>`` ID, minted at
  admission (``batcher``/``router`` ``submit``) and carried on the
  ``_Request`` object through every hop;
- :func:`record_hop` — a zero-duration tracer record (name ``"hop"``) with
  ``request_id`` + ``hop`` attrs, recorded at each lifecycle transition.
  On a disabled tracer it is a no-op (the untraced hot path pays one
  attribute read);
- :func:`hop_chain` / :func:`chains` — reconstruction over an exported
  span stream: filter + sort one request's hops (``trace_tpu.py request
  <id>`` fronts this);
- :func:`chain_issues` — the integrity contract the chaos tests and the
  ``--serve-load`` gate enforce: an accepted request's chain starts with
  ``admit`` and ends with exactly ONE terminal hop (completion is
  first-wins, so a hedged/requeued request must never record two).

Hop vocabulary (the ``hop`` attr):

====================  ====================================================
hop                   meaning / extra attrs
====================  ====================================================
``admit``             admission accepted the request AND it landed in a
                      queue — one hop, both facts (``tier``, ``replica``,
                      ``bucket`` or ``packed``); recording two would
                      double the per-submit tracing cost
``pack``              pack placement assigned (``row``, ``slot``,
                      ``replica``)
``dispatch``          riding an executing batch (``replica``, ``bucket``,
                      ``row`` — and ``slot`` on the packed path,
                      ``retry`` when re-dispatched)
``hedge``             duplicated onto a less-loaded replica
                      (``from_replica``, ``to_replica``)
``requeue``           moved off an ejected replica (``from_replica``,
                      ``to_replica``, ``inflight``, ``packed`` — the
                      eject-time re-pack carries ``packed=True``)
``shadow``            fleet shadow traffic.  On the PRIMARY request's
                      chain: a sampled duplicate was sent to the candidate
                      model (``to_model``, ``shadow_rid``) — non-terminal,
                      the caller still gets the primary's answer.  As the
                      FIRST hop of a chain: this chain IS the shadow
                      duplicate (``of`` = the primary rid, ``model``) —
                      its terminal must carry ``shadow=True`` (it ends on
                      the shadow side, never as a caller-visible answer)
``degrade``           fleet overload re-route: the admission ladder's
                      degrade band sent this arrival to the cheap model
                      instead of shedding it (``from_model``,
                      ``to_model``, ``tier``) — recorded BEFORE the cheap
                      pool's ``admit``, and always before any
                      ``dispatch``, so ``trace_tpu.py request <id>``
                      shows who got the cheap answer and why
``rollback``          fleet canary rollback: the request was queued on the
                      candidate when the rollout rolled back, and was
                      drained back to the primary (``from_model``,
                      ``to_model``) — non-terminal; the request still gets
                      exactly one terminal, on the primary
``prefill``           generative stream: the prompt's causal forward ran
                      and its K/V landed in a claimed cache slot
                      (``slot``, ``tokens_in``, ``replica``).  Appears
                      again after a ``requeue`` — an orphaned stream
                      re-prefills ``prompt + emitted`` on a survivor
``decode``            generative stream: one fixed-shape decode step
                      advanced this stream (``slot``; ``step`` — the
                      index of the token this step produces: token 0
                      comes from prefill, so decode hops carry 1..;
                      ``tokens_out`` — cumulative tokens emitted
                      including this step's).  A streaming
                      chain is ``admit → prefill → decode* → complete``
                      (``decode*`` may be empty: a stream whose first
                      token is EOS or whose budget is 1 completes
                      straight from prefill)
``handoff``           disaggregated pools: the stream's prefilled KV
                      pages moved from a prefill-role engine to a
                      decode-role engine (``from_replica``,
                      ``to_replica``, ``pages``, ``bytes``,
                      ``transport`` — ``local`` or ``socket``).
                      Recorded per placement attempt BEFORE the seat
                      (ordering: the receiver may decode-complete the
                      stream immediately).  A disaggregated chain is
                      ``admit → prefill → handoff → decode* →
                      complete``; a failed dispatch re-prefills at the
                      sender, so ``prefill → handoff → prefill →
                      handoff → …`` is legal recovery
``draft``             speculative decoding: the cheap drafter proposed
                      ``k`` tokens for this stream's next positions
                      through its own paged KV cache (``slot``, ``k``,
                      ``drafter_model``, ``replica``) — always
                      immediately followed by its ``verify``
``verify``            the primary scored all k+1 drafted positions in
                      ONE prefill-shaped call and accepted the longest
                      greedy-matching prefix (``slot``, ``k``,
                      ``matched`` — this round's accepted count,
                      ``accepted`` — the stream's CUMULATIVE accepted
                      drafts, monotone non-decreasing by contract,
                      ``replica``).  A speculated chain is ``admit →
                      prefill → (decode | draft verify)* → complete``
``complete``          logits delivered (terminal; ``replica``; a shadow
                      duplicate's carries ``shadow=True``)
``deadline``          expired before execution (terminal)
``shed``              dropped by the shed tier (terminal)
``rejected``          refused at admission (terminal — the only hop such
                      a request ever records)
``failed``            completed with a non-deadline error (terminal;
                      ``error``)
====================  ====================================================
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence

#: the span-record name every hop record carries
HOP = "hop"

#: hops that end a request's life — exactly one per accepted request
TERMINAL_HOPS = ("complete", "deadline", "shed", "rejected", "failed")

#: how many request IDs a batch-level span carries as exemplars — enough
#: to join a slow batch back to concrete requests, bounded so a 128-wide
#: packed batch does not bloat every span record
EXEMPLAR_CAP = 8

_counter = itertools.count(1)
_pid_prefix: Optional[str] = None


def mint_request_id() -> str:
    """Process-unique request ID (``r<pid>-<n>``): the PID disambiguates
    ranks/replicas that merge their traces, the counter is monotonic so
    IDs are also a stable submission order within one process.  Minted on
    EVERY ``_Request`` (traced or not), so it is prefix-cached — a few µs
    per submit would show up in the serve p50."""
    global _pid_prefix
    if _pid_prefix is None:
        _pid_prefix = f"r{os.getpid()}-"
    return _pid_prefix + str(next(_counter))


def record_hop(tracer, request_id: str, hop: str, **attrs) -> None:
    """One lifecycle transition as a zero-duration tracer record
    (``Tracer.mark`` — the hot-path fast lane).  No-op on a disabled
    tracer — request tracing rides the same ``--trace`` switch as spans,
    so the untraced hot path pays one attribute read."""
    if not tracer.enabled:
        return
    attrs["request_id"] = request_id
    attrs["hop"] = hop
    tracer.mark(HOP, attrs)


def exemplar_ids(requests: Sequence, cap: int = EXEMPLAR_CAP) -> List[str]:
    """The bounded ``request_ids`` attr batch-level spans carry."""
    return [r.rid for r in list(requests)[:cap]]


# ------------------------------------------------------- reconstruction

def hop_chain(records: Sequence[Dict], request_id: str) -> List[Dict]:
    """One request's hops from a span stream, in time order (records
    carry aligned ``t0`` after a cross-rank merge, raw tracer time from a
    single process — both sort correctly)."""
    hops = [r for r in records
            if r.get("name") == HOP
            and (r.get("attrs") or {}).get("request_id") == request_id]
    return sorted(hops, key=lambda r: float(r.get("t0", 0.0)))


def chains(records: Sequence[Dict]) -> Dict[str, List[Dict]]:
    """Every request's hop chain, keyed by request ID."""
    by_id: Dict[str, List[Dict]] = {}
    for r in records:
        if r.get("name") != HOP:
            continue
        rid = (r.get("attrs") or {}).get("request_id")
        if rid is not None:
            by_id.setdefault(rid, []).append(r)
    for hops in by_id.values():
        hops.sort(key=lambda r: float(r.get("t0", 0.0)))
    return by_id


def chain_issues(chain: Sequence[Dict]) -> List[str]:
    """Integrity violations of one hop chain (empty list = complete).

    A complete accepted-request chain: starts with ``admit``, contains
    exactly ONE terminal hop, and the terminal hop is last.  (A rejected
    request's whole chain is the single ``rejected`` hop — also
    complete.)  The fleet hops extend the contract:

    - a chain may open with a ``degrade`` preamble (the fleet re-routed
      the arrival to the cheap model BEFORE that pool admitted it) — it
      must be followed by ``admit`` (or a door refusal), and every
      ``degrade`` must precede the first ``dispatch`` (a request cannot
      be "degraded" after it already executed);
    - a chain opening with ``shadow`` IS a shadow duplicate: it must
      still terminate exactly once, and its terminal must carry
      ``shadow=True`` — a shadow chain with a caller-visible terminal
      means a candidate answer could have leaked to a caller;
    - ``rollback`` is non-terminal: a rolled-back canary request still
      gets exactly one terminal (on the primary it was drained back to);
    - a STREAMING chain (``prefill``/``decode`` hops — generative
      serving) must prefill before it decodes: every ``decode`` hop needs
      an earlier ``prefill``, and a chain with a ``prefill`` must have
      admitted first.  ``admit → prefill → decode* → complete`` is the
      happy path; a mid-decode replica kill inserts ``requeue`` followed
      by a SECOND ``prefill`` on the survivor (the continuation re-runs
      ``prompt + emitted``), which is legal — what is not legal is
      decoding from a cache no prefill filled;
    - a SPECULATED chain (``draft``/``verify`` hops) pairs them: every
      ``verify`` must immediately follow its ``draft`` (a verification
      with no drafted window scored nothing) and every ``draft`` must be
      immediately followed by its ``verify`` (a drafted window nobody
      verified could leak unverified tokens); a ``draft`` needs an
      earlier ``prefill`` like any decode; and the ``accepted`` attr —
      the stream's cumulative accepted drafts — must be monotone
      non-decreasing across its ``verify`` hops.

    Deliberately NO timestamp-order check here:
    :func:`hop_chain`/:func:`chains` hand over chains already sorted by
    ``t0``, so such a check could never fire — the time ordering that IS
    enforced is the merged timeline's (``trace_tpu.py merge`` sorts, the
    merge tests pin monotonicity)."""
    issues: List[str] = []
    if not chain:
        return ["empty chain"]
    attrs = [(r.get("attrs") or {}) for r in chain]
    hops = [a.get("hop") for a in attrs]
    if len(hops) == 1 and hops[0] in ("rejected", "shed"):
        return []  # refused at the door: the one hop IS the whole life
    shadow_side = hops[0] == "shadow"
    if shadow_side:
        if len(hops) < 2 or hops[1] not in ("admit", "rejected", "shed"):
            issues.append("shadow duplicate not followed by 'admit' (or "
                          "a door refusal)")
    elif hops[0] == "degrade":
        if len(hops) < 2 or hops[1] not in ("admit", "rejected", "shed"):
            issues.append("degrade re-route not followed by 'admit' (or "
                          "a door refusal)")
    elif hops[0] != "admit":
        issues.append(f"first hop is {hops[0]!r}, not 'admit'")
    if "dispatch" in hops:
        first_dispatch = hops.index("dispatch")
        if any(h == "degrade" for h in hops[first_dispatch + 1:]):
            issues.append("'degrade' hop recorded after a dispatch — a "
                          "degrade decision must precede execution")
    if "decode" in hops:
        first_decode = hops.index("decode")
        if "prefill" not in hops[:first_decode]:
            issues.append("'decode' hop with no earlier 'prefill' — the "
                          "stream decoded from a cache slot no prefill "
                          "filled")
    if "handoff" in hops:
        first_handoff = hops.index("handoff")
        if "prefill" not in hops[:first_handoff]:
            issues.append("'handoff' hop with no earlier 'prefill' — no "
                          "prefilled pages existed to hand off")
    if "draft" in hops or "verify" in hops:
        for i, h in enumerate(hops):
            if h == "verify" and (i == 0 or hops[i - 1] != "draft"):
                issues.append("'verify' hop not immediately preceded by "
                              "its 'draft' — a verification with no "
                              "drafted window")
                break
            if h == "draft" and (i + 1 >= len(hops)
                                 or hops[i + 1] != "verify"):
                issues.append("'draft' hop not immediately followed by "
                              "its 'verify' — a drafted window nobody "
                              "verified")
                break
        if "draft" in hops:
            first_draft = hops.index("draft")
            if "prefill" not in hops[:first_draft]:
                issues.append("'draft' hop with no earlier 'prefill' — "
                              "the drafter proposed from a cache no "
                              "prefill filled")
        acc = [a.get("accepted") for a, h in zip(attrs, hops)
               if h == "verify" and a.get("accepted") is not None]
        if any(b < a for a, b in zip(acc, acc[1:])):
            issues.append("'verify' accepted counts not monotone "
                          "non-decreasing — cumulative acceptance ran "
                          "backwards")
    terminals = [h for h in hops if h in TERMINAL_HOPS]
    if len(terminals) == 0:
        issues.append("no terminal hop (orphaned request)")
    elif len(terminals) > 1:
        issues.append(f"{len(terminals)} terminal hops (duplicate "
                      f"completion): {terminals}")
    else:
        if shadow_side:
            term_attrs = attrs[hops.index(terminals[0])]
            if not term_attrs.get("shadow"):
                issues.append(
                    f"shadow duplicate terminated with a CALLER-VISIBLE "
                    f"{terminals[0]!r} (no shadow=True) — the candidate's "
                    "answer may have reached a caller")
        # trailing dispatch/pack hops are BENIGN: a hedge's losing copy
        # (or a batch formed just before the monitor completed the
        # request) may record its execution marker microseconds after
        # the winner's terminal — that is truthful telemetry of a
        # duplicate execution, not an integrity violation.  A trailing
        # `shadow` is the same shape: the fleet samples the duplicate
        # right after the primary submit, and a fast engine can complete
        # the primary in that window.  Anything ELSE after the terminal
        # (a requeue, a rollback, a second admit) is a violation.
        tail = hops[hops.index(terminals[0]) + 1:]
        stray = [h for h in tail if h not in ("dispatch", "pack",
                                              "shadow")]
        if stray:
            issues.append(f"hop(s) {stray} recorded after the terminal "
                          f"{terminals[0]!r}")
    return issues


def validate_chains(records: Sequence[Dict],
                    request_ids: Optional[Sequence[str]] = None) -> Dict:
    """Chain-integrity report over a span stream: how many chains are
    complete, which are not (and why), and how many crossed a replica
    ejection via requeue/re-pack — the ``--serve-load`` gate's input."""
    by_id = chains(records)
    ids = list(request_ids) if request_ids is not None \
        else sorted(by_id)
    report = {"checked": len(ids), "complete": 0, "incomplete": {},
              "requeued": 0, "repacked": 0, "hedged": 0,
              "shadowed": 0, "degraded": 0, "rolled_back": 0,
              "streamed": 0, "re_prefilled": 0, "handed_off": 0,
              "speculated": 0, "accept_rate": None}
    drafted = accepted = 0
    for rid in ids:
        chain = by_id.get(rid, [])
        issues = chain_issues(chain)
        if issues:
            report["incomplete"][rid] = issues
        else:
            report["complete"] += 1
        hops = [(r.get("attrs") or {}) for r in chain]
        if any(h.get("hop") == "requeue" for h in hops):
            report["requeued"] += 1
        if any(h.get("hop") == "requeue" and h.get("packed")
               for h in hops):
            report["repacked"] += 1
        if any(h.get("hop") == "hedge" for h in hops):
            report["hedged"] += 1
        if hops and hops[0].get("hop") == "shadow":
            report["shadowed"] += 1
        if any(h.get("hop") == "degrade" for h in hops):
            report["degraded"] += 1
        if any(h.get("hop") == "rollback" for h in hops):
            report["rolled_back"] += 1
        prefills = sum(1 for h in hops if h.get("hop") == "prefill")
        if prefills:
            report["streamed"] += 1
        if prefills > 1:  # a requeued stream re-prefilled on a survivor
            report["re_prefilled"] += 1
        if any(h.get("hop") == "handoff" for h in hops):
            report["handed_off"] += 1  # crossed the disagg pool boundary
        drafts = [h for h in hops if h.get("hop") == "draft"]
        if drafts:
            report["speculated"] += 1
            drafted += sum(int(h.get("k") or 0) for h in drafts)
            accepted += sum(int(h.get("matched") or 0) for h in hops
                            if h.get("hop") == "verify")
    if drafted:
        report["accept_rate"] = round(accepted / drafted, 4)
    return report


def format_chain(chain: Sequence[Dict], request_id: str) -> str:
    """The ``trace_tpu.py request <id>`` table: one line per hop with the
    offset since admission and the duration of the hop-to-hop gap."""
    if not chain:
        return f"request {request_id}: no hops found"
    t_first = float(chain[0].get("t0", 0.0))
    header = (f"{'hop':<10} {'t+ms':>10} {'gap_ms':>10}  detail")
    lines = [f"request {request_id}: {len(chain)} hop(s)",
             header, "-" * len(header)]
    prev = t_first
    for rec in chain:
        attrs = dict(rec.get("attrs") or {})
        attrs.pop("request_id", None)
        hop = attrs.pop("hop", "?")
        t = float(rec.get("t0", 0.0))
        detail = "  ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
        lines.append(f"{hop:<10} {(t - t_first) * 1e3:>10.3f} "
                     f"{(t - prev) * 1e3:>10.3f}  {detail}")
        prev = t
    issues = chain_issues(chain)
    lines.append("chain: " + ("complete" if not issues
                              else "INCOMPLETE — " + "; ".join(issues)))
    return "\n".join(lines)
