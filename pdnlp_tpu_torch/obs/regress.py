"""Rolling step-time regression detection + trace-to-trace diffing — the
port's copy of ``pdnlp_tpu/obs/regress.py``.

Two consumers of the phase breakdown:

- **online** (:class:`RegressionDetector`) — rides the training loop via
  ``StepBreakdown(on_step=detector.observe)``.  Per phase it keeps an EWMA
  baseline of the per-step seconds and flags two distinct pathologies:

  * ``slowdown`` — the phase has run over ``slow_ratio``× its baseline for
    ``sustain`` consecutive steps (a real regression: a cache gone cold, a
    competing process, a shrinking overlap window);
  * ``stall`` — a single observation over ``spike_ratio``× baseline (a
    one-off hiccup: GC pause, checkpoint flush, page-cache miss).

  It also maintains ``last_step`` / ``steps_per_sec`` (EWMA of the step
  rate) — the heartbeat metadata that lets the launcher-side
  gang monitor (``parallel.watchdog.GangMonitor``) tell a SLOW gang
  (beats arriving, step counter advancing, rate depressed) from a DEAD one
  (beats stopped) without guessing from file mtimes.

- **offline** (:func:`diff_breakdowns`) — ``trace_tpu.py diff``: per-phase
  mean deltas between two exported traces, flagging phases whose mean grew
  beyond a threshold.  This is the CI shape of the same question: "did
  this PR make a phase slower?"
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class PhaseEwma:
    """EWMA mean of one phase's per-step seconds (+ observation count)."""

    __slots__ = ("alpha", "mean", "count")

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.count = 0

    def update(self, x: float) -> None:
        self.count += 1
        self.mean = x if self.mean is None \
            else self.mean + self.alpha * (x - self.mean)


class RegressionDetector:
    """Per-phase EWMA baselines -> slowdown/stall events (module doc).

    ``warmup`` observations per phase establish the baseline before any
    flagging (the first steps after compile are not a regression).  A
    spike is deliberately NOT folded into the baseline — one GC pause must
    not license the next one — while sustained values are (the EWMA tracks
    genuine drift so a recovered phase re-arms cleanly).
    """

    def __init__(self, *, alpha: float = 0.1, warmup: int = 5,
                 sustain: int = 5, slow_ratio: float = 1.3,
                 spike_ratio: float = 3.0,
                 on_event: Optional[Callable[[Dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.alpha = alpha
        self.warmup = int(warmup)
        self.sustain = int(sustain)
        self.slow_ratio = float(slow_ratio)
        self.spike_ratio = float(spike_ratio)
        self.on_event = on_event
        self._clock = clock
        self._baselines: Dict[str, PhaseEwma] = {}
        self._over: Dict[str, int] = {}    # consecutive slow observations
        self._flagged: Dict[str, bool] = {}  # one event per sustained run
        self.events: List[Dict] = []
        self.last_step: Optional[int] = None
        self.steps_per_sec: Optional[float] = None
        self._rate = PhaseEwma(alpha)

    # ------------------------------------------------------------- observe
    def observe(self, step: int, phases: Dict[str, float],
                wall_sec: float) -> List[Dict]:
        """One closed step; returns the events it raised (also appended to
        ``self.events`` / delivered to ``on_event``)."""
        raised: List[Dict] = []
        n = max(1, step - self.last_step) if self.last_step is not None else 1
        self.last_step = int(step)
        if wall_sec > 0:
            self._rate.update(n / wall_sec)
            self.steps_per_sec = self._rate.mean
        for phase, sec in phases.items():
            ewma = self._baselines.setdefault(phase, PhaseEwma(self.alpha))
            base = ewma.mean
            if base is not None and base > 0 and ewma.count >= self.warmup:
                if sec > self.spike_ratio * base:
                    raised.append({"kind": "stall", "phase": phase,
                                   "step": int(step), "sec": round(sec, 6),
                                   "baseline_sec": round(base, 6),
                                   "ratio": round(sec / base, 2)})
                    # a spike is excluded from the baseline (doc above)
                    continue
                if sec > self.slow_ratio * base:
                    self._over[phase] = self._over.get(phase, 0) + 1
                    if self._over[phase] >= self.sustain \
                            and not self._flagged.get(phase):
                        self._flagged[phase] = True
                        raised.append({
                            "kind": "slowdown", "phase": phase,
                            "step": int(step), "sec": round(sec, 6),
                            "baseline_sec": round(base, 6),
                            "ratio": round(sec / base, 2),
                            "sustained_steps": self._over[phase]})
                else:
                    self._over[phase] = 0
                    self._flagged[phase] = False
            ewma.update(sec)
        for ev in raised:
            self.events.append(ev)
            if self.on_event is not None:
                self.on_event(ev)
        return raised

    # ----------------------------------------------------------- heartbeat
    def heartbeat_payload(self) -> Dict:
        """What the worker folds into its watchdog heartbeat."""
        out: Dict = {}
        if self.last_step is not None:
            out["step"] = self.last_step
        if self.steps_per_sec is not None:
            out["steps_per_sec"] = round(self.steps_per_sec, 3)
        return out


# -------------------------------------------------------------- trace diff

def diff_breakdowns(base: Dict, cand: Dict, *, threshold: float = 0.2,
                    min_mean_sec: float = 1e-6,
                    min_count: int = 5,
                    ckpt_save_budget: Optional[float] = None) -> Dict:
    """Per-phase mean delta of two ``StepBreakdown.summary()`` dicts.

    ``threshold`` is a fraction (0.2 = flag a phase whose mean grew >=20%).
    Two noise guards keep the exit-code honest: phases under
    ``min_mean_sec`` in the BASE trace are compared but never flagged (a
    2µs phase doubling is measurement noise), and so are phases with fewer
    than ``min_count`` observations in either trace — the resident
    pipeline's amortized uploads appear 1-2 times per run and their
    sub-ms mean swings ±100% between identical configs; one sample is an
    anecdote, not a distribution.  Returns
    ``{"phases": {...}, "regressions": [names...]}``.

    ``ckpt_save_budget`` (seconds) additionally gates the CANDIDATE
    trace's in-loop ``ckpt_save`` p95 as an ABSOLUTE bound, independent of
    the base trace: the async checkpointer's contract is that the step
    loop pays the device→host snapshot only, so a p95 over budget means
    serialization/disk crept back onto the loop (the end-of-run drain
    reports separately as ``ckpt_wait`` and is never gated here).  A trace
    with no ``ckpt_save`` observations passes vacuously.
    """
    phases: Dict[str, Dict] = {}
    regressions: List[str] = []
    a, b = base.get("phases", {}), cand.get("phases", {})
    for name in sorted(set(a) | set(b)):
        am = a.get(name, {}).get("mean_sec")
        bm = b.get(name, {}).get("mean_sec")
        n = min(a.get(name, {}).get("count", 0),
                b.get(name, {}).get("count", 0))
        row: Dict = {"base_mean_sec": am, "cand_mean_sec": bm}
        if am and bm:
            row["delta_ratio"] = round(bm / am - 1.0, 4)
            row["regressed"] = bool(am >= min_mean_sec
                                    and n >= min_count
                                    and bm / am - 1.0 >= threshold)
            if row["regressed"]:
                regressions.append(name)
        else:
            row["delta_ratio"] = None
            row["regressed"] = False
        phases[name] = row
    out = {"threshold": threshold, "phases": phases,
           "regressions": regressions}
    # kernel/precision adoption (summary "impls"): surfaced so a phase
    # delta caused by an impl change (xla -> pallas attention, bf16 ->
    # int8 serving) is attributable from the diff alone.  Informational —
    # an intentional adoption change SHOULD move phase means; the exit
    # code stays about unexplained regressions.
    ia, ib = base.get("impls"), cand.get("impls")
    if ia or ib:
        out["impls"] = {"base": ia, "cand": ib, "changed": ia != ib}
    if ckpt_save_budget is not None:
        p95 = cand.get("phases", {}).get("ckpt_save", {}).get("p95_sec")
        exceeded = bool(p95 is not None and p95 > ckpt_save_budget)
        out["ckpt_save_budget"] = {"budget_sec": ckpt_save_budget,
                                   "cand_p95_sec": p95,
                                   "exceeded": exceeded}
        if exceeded:
            out["regressions"].append("ckpt_save(p95-budget)")
    return out
