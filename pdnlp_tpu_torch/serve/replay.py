"""Trace-driven load replay: recorded traffic, re-playable at will (the
twin of ``pdnlp_tpu/serve/replay.py``: pure ``random`` and ``math``, so
the same seed gives the same schedule in both packages, exactly).

Capacity planning for millions-of-users traffic needs *reproducible*
storms: the same arrival process, replayed at 1x/5x/20x speed, reshaped
into the diurnal ramps and flash crowds production actually sees, against
any pool configuration — so a controller-vs-static comparison is a seeded
experiment, not an anecdote.

The recording already exists: every admitted request's hop chain
(:mod:`pdnlp_tpu_torch.obs.request`) carries its admission timestamp, and
the ``admit`` hop also carries ``tokens`` and ``deadline_ms`` — a flushed
trace file IS a load recording.  This module closes the loop:

- :func:`arrivals_from_trace` — reconstruct the arrival process
  (relative timestamp, token length, deadline) from a span stream's hop
  chains;
- :func:`synth_arrivals` — a seeded Poisson arrival process with a mixed
  length/deadline distribution, for recording-free use (and for seeding
  the recording storm itself);
- :func:`shape_arrivals` — deterministic time-warps over a base schedule:
  ``steady`` (pure speedup), ``diurnal`` (a low -> peak -> low rate ramp,
  the daily traffic curve compressed), ``flash`` (a sustained burst at
  ``flash_factor`` x the base rate mid-replay — the thundering-herd
  shape).  Pure functions of their inputs: same trace + same shape/speed
  -> identical schedule, bit for bit;
- :func:`replay` — drive a schedule through any ``submit_ids``-shaped
  callable open-loop (arrivals happen when the schedule says, whether or
  not the pool is keeping up — that is the point), collecting per-request
  outcomes and the goodput/latency numbers a controller-vs-static
  comparison reads.

Everything is stdlib + injectable clocks; nothing here imports torch.
"""
from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

from pdnlp_tpu_torch.obs.request import chains


class Arrival:
    """One request of a replayable schedule: WHEN (seconds since the
    schedule's start), how BIG (real tokens), and how URGENT."""

    __slots__ = ("t", "tokens", "deadline_ms")

    def __init__(self, t: float, tokens: int,
                 deadline_ms: Optional[float] = None):
        self.t = float(t)
        self.tokens = int(tokens)
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Arrival(t={self.t:.6f}, tokens={self.tokens}, "
                f"deadline_ms={self.deadline_ms})")

    def as_tuple(self) -> tuple:
        return (round(self.t, 9), self.tokens, self.deadline_ms)


def arrivals_from_trace(records: Sequence[Dict]) -> List[Arrival]:
    """The arrival process a span stream recorded: one :class:`Arrival`
    per ``admit`` hop (relative to the first admission, time-ordered).
    Chains without a ``tokens`` attr (pre-control-plane traces) fall back
    to the admit hop's ``bucket`` width; chains with neither are skipped
    — a replay must never invent work that was not recorded."""
    out: List[Arrival] = []
    for chain in chains(records).values():
        first = chain[0]
        attrs = dict(first.get("attrs") or {})
        if attrs.get("hop") != "admit":
            continue
        tokens = attrs.get("tokens", attrs.get("bucket"))
        if tokens is None:
            continue
        out.append(Arrival(float(first.get("t0", 0.0)), int(tokens),
                           attrs.get("deadline_ms")))
    out.sort(key=lambda a: a.t)
    if out:
        t0 = out[0].t
        for a in out:
            a.t -= t0
    return out


def synth_arrivals(n: int, qps: float, *,
                   lengths: Sequence[int] = (6, 10, 16, 22, 28),
                   deadline_ms: Optional[float] = 8000.0,
                   seed: int = 0) -> List[Arrival]:
    """A seeded Poisson arrival process (exponential gaps at ``qps``) with
    lengths cycling the given mix — the recording-free schedule source."""
    rng = random.Random(seed)
    t = 0.0
    out: List[Arrival] = []
    for i in range(int(n)):
        out.append(Arrival(t, lengths[i % len(lengths)], deadline_ms))
        t += rng.expovariate(qps)
    return out


#: the supported traffic shapes (rate multiplier over replay progress)
SHAPES = ("steady", "diurnal", "flash")


def _rate_multiplier(shape: str, u: float, flash_factor: float,
                     diurnal_low: float, diurnal_peak: float) -> float:
    """Instantaneous arrival-rate multiplier at progress ``u`` in [0, 1)."""
    if shape == "steady":
        return 1.0
    if shape == "diurnal":
        # low -> peak -> low over the replay: half a sine period riding on
        # the trough rate — the daily curve compressed into one run
        return diurnal_low + (diurnal_peak - diurnal_low) \
            * math.sin(math.pi * u)
    if shape == "flash":
        # a sustained mid-replay burst: the thundering herd arrives at
        # flash_factor x the base rate, then leaves as fast as it came
        return flash_factor if 0.45 <= u < 0.65 else 1.0
    raise ValueError(f"unknown shape {shape!r} (supported: {SHAPES})")


def shape_arrivals(base: Sequence[Arrival], shape: str, *,
                   speed: float = 1.0, flash_factor: float = 8.0,
                   diurnal_low: float = 0.35, diurnal_peak: float = 1.8
                   ) -> List[Arrival]:
    """Deterministic time-warp of a base schedule: each inter-arrival gap
    is divided by ``speed x rate_multiplier(progress)``, so the SAME
    requests (lengths, deadlines, order) arrive on a reshaped clock.
    Progress is indexed, not timed — the warp is a pure function of the
    base schedule, which is what makes replays reproducible."""
    if speed <= 0:
        raise ValueError(f"speed must be positive, got {speed}")
    out: List[Arrival] = []
    t = 0.0
    prev = None
    n = max(1, len(base))
    for i, a in enumerate(base):
        if prev is not None:
            mult = _rate_multiplier(shape, i / n, flash_factor,
                                    diurnal_low, diurnal_peak)
            t += (a.t - prev) / (speed * mult)
        prev = a.t
        out.append(Arrival(t, a.tokens, a.deadline_ms))
    return out


def ids_for(arrival: Arrival, index: int, *, cls_id: int = 2,
            sep_id: int = 3, vocab: int = 200, base_id: int = 5
            ) -> List[int]:
    """Deterministic token ids for one replayed arrival: the recorded
    LENGTH is what shapes serving (bucketing, packing, fill); the ids only
    need to be valid and reproducible.  ``[CLS] body... [SEP]`` framed,
    body derived from the arrival index."""
    body = max(0, arrival.tokens - 2)
    return [cls_id] + [base_id + ((index * 31 + j) % vocab)
                       for j in range(body)] + [sep_id]


class ReplayReport:
    """One replay run's outcome accounting (JSON-ready via
    :meth:`as_dict`)."""

    def __init__(self) -> None:
        self.submitted = 0
        self.ok = 0
        self.deadline = 0
        self.shed = 0
        self.rejected = 0
        self.lost = 0
        self.tokens_ok = 0
        self.elapsed_s = 0.0
        self.max_lag_s = 0.0   # worst pacing slip (loaded host diagnostics)

    @property
    def goodput_tokens_per_s(self) -> float:
        return self.tokens_ok / self.elapsed_s if self.elapsed_s else 0.0

    def as_dict(self) -> Dict:
        return {
            "submitted": self.submitted, "ok": self.ok,
            "deadline": self.deadline, "shed": self.shed,
            "rejected": self.rejected, "lost": self.lost,
            "tokens_ok": self.tokens_ok,
            "elapsed_s": round(self.elapsed_s, 3),
            "goodput_tokens_per_s": round(self.goodput_tokens_per_s, 1),
            "max_lag_s": round(self.max_lag_s, 3),
        }


def replay(submit_ids: Callable, schedule: Sequence[Arrival], *,
           make_ids: Callable[[Arrival, int], List[int]] = ids_for,
           result_timeout: float = 120.0,
           clock: Callable[[], float] = time.monotonic,
           sleep: Callable[[float], None] = time.sleep,
           on_tick: Optional[Callable[[int], None]] = None
           ) -> ReplayReport:
    """Drive a schedule through ``submit_ids(ids, deadline_ms=...)``
    open-loop: each arrival is submitted at its scheduled offset (pacing
    slips on a loaded host are measured into ``max_lag_s``, never
    silently absorbed), futures are resolved at the end, and the report
    carries the outcome split + goodput.  ``on_tick(i)`` (optional) runs
    before arrival ``i`` — a kill/injection hook."""
    from pdnlp_tpu_torch.serve.batcher import (
        DeadlineExceeded, LoadShedError, QueueFullError,
    )

    rep = ReplayReport()
    futs = []
    t0 = clock()
    for i, a in enumerate(schedule):
        if on_tick is not None:
            on_tick(i)
        due = t0 + a.t
        now = clock()
        if now < due:
            sleep(due - now)
        else:
            rep.max_lag_s = max(rep.max_lag_s, now - due)
        rep.submitted += 1
        try:
            futs.append((a, submit_ids(make_ids(a, i),
                                       deadline_ms=a.deadline_ms)))
        except LoadShedError:
            rep.shed += 1
        except QueueFullError:
            rep.rejected += 1
    for a, f in futs:
        try:
            f.result(timeout=result_timeout)
            rep.ok += 1
            rep.tokens_ok += a.tokens
        except DeadlineExceeded:
            rep.deadline += 1
        except LoadShedError:
            rep.shed += 1
        except Exception:  # noqa: BLE001 — replica error/timeout = LOST
            rep.lost += 1
    rep.elapsed_s = clock() - t0
    return rep
