"""Failure detection for multi-process gangs and serving replicas — the
port's copy of the ``Heartbeat`` and ``GangMonitor`` of
``pdnlp_tpu/parallel/watchdog.py``.

- **Heartbeat** (worker side): each process, or each replica worker of
  the serving router, touches a per-rank file at a bounded rate.  A wedged
  device stream, a deadlocked collective or a killed worker all stop the
  beats.
- **GangMonitor** (supervisor side): polls child liveness and heartbeat
  freshness, and classifies the gang as ``crashed`` (a child exited
  nonzero) or ``stalled`` (a heartbeat older than the timeout), naming the
  dead ranks.  ``serve.router`` reads its replicas through it.
- **GangSupervisor** (launcher side, ``train.spawn --elastic true``): on
  a failure verdict the whole gang is killed and relaunched from the newest
  resume snapshot, at the surviving width when the verdict names dead
  ranks, after a capped exponential backoff and within a restart budget.
  The resume is bit for bit at the same width; at another width the data
  position is remapped by epoch fraction (``train.trainer``).  The unit of
  restart is the whole gang: a lone replacement rank cannot rejoin a
  process group whose peers are wedged in a collective.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional


def heartbeat_dir(output_dir: str) -> str:
    return os.path.join(output_dir, "heartbeats")


def heartbeat_file(output_dir: str, process_index: int) -> str:
    return os.path.join(heartbeat_dir(output_dir), f"proc{process_index}")


class Heartbeat:
    """Rate-limited liveness beacon written from the training loop.

    A beat may carry progress metadata — ``step`` (the rank's global step)
    and ``steps_per_sec`` — written into the beat file as JSON so the
    launcher-side monitor can tell a SLOW gang (beats arriving, counter
    advancing) from a DEAD one (beats stopped).  When the caller supplies
    only ``step``, the rate is derived from consecutive beats; the obs
    regression detector supplies its smoothed rate directly
    (``RegressionDetector.heartbeat_payload``).

    ``clock`` is injectable (tests drive a fake clock instead of
    sleeping); it must be the same clock the monitor reads, and defaults
    to ``time.time`` on both sides.
    """

    def __init__(self, output_dir: str, process_index: int,
                 interval: float = 5.0,
                 clock: Callable[[], float] = time.time):
        self.path = heartbeat_file(output_dir, process_index)
        self.interval = interval
        self._clock = clock
        self._last = 0.0
        self._prev: Optional[tuple] = None  # (beat time, step) for the rate
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        # deliberately NO beat here: the first beat lands after the first
        # completed step, so the monitor's pre-first-beat grace window (4x
        # stall_timeout) covers rendezvous and the first compile — an early beat
        # would start the stall clock before compilation finishes

    def beat(self, force: bool = False, step: Optional[int] = None,
             steps_per_sec: Optional[float] = None,
             hbm: Optional[int] = None,
             hbm_peak: Optional[int] = None) -> None:
        now = self._clock()
        if not (force or (now - self._last) >= self.interval):
            return
        self._last = now
        rate = steps_per_sec
        if rate is None and step is not None and self._prev is not None:
            dt = now - self._prev[0]
            ds = step - self._prev[1]
            if dt > 0 and ds >= 0:
                rate = ds / dt
        if step is not None:
            self._prev = (now, int(step))
        payload: Dict = {"t": now}
        # the tracer-clock anchor: (t, mono) read back-to-back lets
        # a trace merge align this rank's perf_counter span domain against
        # other ranks'
        payload["mono"] = time.perf_counter()
        if step is not None:
            payload["step"] = int(step)
        if rate is not None:
            payload["steps_per_sec"] = round(float(rate), 3)
        if hbm is not None:
            payload["hbm"] = int(hbm)
        if hbm_peak is not None:
            payload["hbm_peak"] = int(hbm_peak)
        # write-then-rename: the monitor must never read a torn beat
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


class GangMonitor:
    """Launcher-side failure detector over child processes + heartbeats."""

    def __init__(self, procs: List, output_dir: str, num_processes: int,
                 stall_timeout: float = 120.0,
                 clock: Callable[[], float] = time.time):
        self.procs = procs
        self.output_dir = output_dir
        self.num_processes = num_processes
        self.stall_timeout = stall_timeout
        self._clock = clock
        self.started = clock()

    def _read_beat(self, process_index: int) -> Optional[Dict]:
        """One rank's beat payload ``{"t": ..., "step"?, "steps_per_sec"?}``
        or None.  The beat TIMESTAMP comes from the payload the worker
        wrote (same injected clock domain as this monitor — and immune to
        the coarse-mtime granularity that made the stall test flaky);
        mtime is only the fallback for legacy plain-float files."""
        p = heartbeat_file(self.output_dir, process_index)
        try:
            with open(p) as f:
                text = f.read()
        except OSError:
            return None
        try:
            payload = json.loads(text)
            if not isinstance(payload, dict):
                payload = {"t": float(payload)}
        except (ValueError, TypeError):
            try:
                payload = {"t": float(text)}
            except ValueError:
                try:
                    payload = {"t": os.path.getmtime(p)}
                except OSError:
                    return None
        return payload if "t" in payload else None

    def _read_beats(self) -> List[Optional[Dict]]:
        """One payload (or None) per rank — read ONCE per poll/status, so
        age and progress never pay a second filesystem pass."""
        return [self._read_beat(i) for i in range(self.num_processes)]

    def _rank_ages(self, beats: Optional[List] = None) -> List[Optional[float]]:
        """Per-rank beat age in seconds (None = that rank has not beaten in
        THIS incarnation — beats older than the monitor's start are
        leftovers from a previous gang, not beats)."""
        now = self._clock()
        ages: List[Optional[float]] = []
        for beat in self._read_beats() if beats is None else beats:
            if beat is None or beat["t"] < self.started:
                ages.append(None)
            else:
                ages.append(now - beat["t"])
        return ages

    def _heartbeat_age(self, beats: Optional[List] = None) -> Optional[float]:
        """Age in seconds of the STALEST rank heartbeat (None before all
        ranks have beaten)."""
        ages = self._rank_ages(beats)
        if any(a is None for a in ages):
            return None  # not all ranks beating yet — grace period
        return max(ages) if ages else None

    @staticmethod
    def _progress(beats: List[Optional[Dict]]) -> Dict:
        """Gang progress metadata from the beat payloads: the SLOWEST
        rank's step (the gang advances at its laggard's pace), its rate,
        and the HOTTEST rank's peak HBM (the budget binds at the fullest
        device, obs.memory rides the beats)."""
        steps = []
        rates = []
        hbm_peaks = []
        for beat in beats:
            beat = beat or {}
            if "step" in beat:
                steps.append(int(beat["step"]))
            if "steps_per_sec" in beat:
                rates.append(float(beat["steps_per_sec"]))
            if "hbm_peak" in beat:
                hbm_peaks.append(int(beat["hbm_peak"]))
        out: Dict = {}
        if steps:
            out["last_step"] = min(steps)
        if rates:
            out["steps_per_sec"] = round(min(rates), 3)
        if hbm_peaks:
            out["hbm_peak_gb"] = round(max(hbm_peaks) / 2**30, 3)
        return out

    def status(self) -> Dict:
        """Instantaneous health snapshot (no verdict): stalest beat age +
        progress metadata — what distinguishes *slow* (step advancing,
        rate depressed) from *dead* (beats stopped)."""
        beats = self._read_beats()
        age = self._heartbeat_age(beats)
        out = {"stalest_beat_s": round(age, 1) if age is not None else None}
        out.update(self._progress(beats))
        return out

    def status_line(self) -> str:
        s = self.status()
        parts = [f"stalest beat "
                 f"{s['stalest_beat_s']}s" if s["stalest_beat_s"] is not None
                 else "no beats yet"]
        if "last_step" in s:
            parts.append(f"step {s['last_step']}")
        if "steps_per_sec" in s:
            parts.append(f"{s['steps_per_sec']} steps/s")
        if "hbm_peak_gb" in s:
            parts.append(f"peak HBM {s['hbm_peak_gb']} GB")
        return "[gang] " + "  ".join(parts)

    def poll(self) -> Optional[Dict]:
        """None while healthy; otherwise a verdict dict:
        ``{"kind": "crashed"|"stalled", ...}``.  ``kind`` is None-equivalent
        ("done") when every child exited 0.  Stall verdicts carry the last
        known ``last_step``/``steps_per_sec`` so the launcher's log shows
        where progress stopped, not just that it did.

        Failure verdicts also carry ``dead_ranks`` — the ranks CLASSIFIED
        dead (a nonzero exit, or beats stopped past the timeout), never
        merely slow (a slow rank keeps beating, its ``steps_per_sec`` just
        drops) — the eviction policy's input: the supervisor shrinks the
        gang to the survivors instead of restarting at full width and dying
        again on the same bad host."""
        codes = [p.poll() for p in self.procs]
        if any(c is not None and c != 0 for c in codes):
            return {"kind": "crashed", "codes": codes,
                    "dead_ranks": [i for i, c in enumerate(codes)
                                   if c is not None and c != 0]}
        if all(c == 0 for c in codes):
            return {"kind": "done", "codes": codes}
        beats = self._read_beats()
        ages = self._rank_ages(beats)
        age = self._heartbeat_age(beats)
        if age is not None and age > self.stall_timeout:
            return {"kind": "stalled", "stalest_beat_s": round(age, 1),
                    "codes": codes,
                    "dead_ranks": [i for i, a in enumerate(ages)
                                   if a is not None and a > self.stall_timeout],
                    **self._progress(beats)}
        # also treat "no rank ever beat within the timeout" (e.g. rendezvous
        # deadlock at startup) as a stall; ranks that never produced a beat
        # count as dead alongside any whose beats went stale
        if age is None and (self._clock() - self.started) > 4 * self.stall_timeout:
            return {"kind": "stalled", "stalest_beat_s": None, "codes": codes,
                    "dead_ranks": [i for i, a in enumerate(ages)
                                   if a is None or a > self.stall_timeout],
                    **self._progress(beats)}
        return None

    def kill_gang(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in self.procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                p.kill()


class GangSupervisor:
    """Degrade-don't-die gang supervision: relaunch, evict, back off (the
    JAX package's policy loop over :class:`GangMonitor` verdicts, its
    ``[elastic]`` lines word for word):

    - **restart** the whole gang from the newest snapshot on any failure;
    - **evict** when the verdict names dead ranks (crashed, or beats
      stopped — never merely slow): the next incarnation launches at the
      surviving width, and the workers' resume remaps the data position.
      A verdict that condemns the ENTIRE gang (a startup rendezvous
      wedge, a whole-gang stall) restarts at full width: there is no
      survivor set to degrade to;
    - **capped exponential backoff** between restarts;
    - **restart budget**: after ``max_restarts`` failures it gives up with
      the final verdict on stderr and returns 1.

    ``launch(width)`` returns the new gang's processes; ``sleep`` and
    ``clock`` are injectable for tests."""

    def __init__(self, launch, output_dir: str, num_processes: int, *,
                 stall_timeout: float = 300.0, max_restarts: int = 2,
                 shrink: bool = True, min_processes: int = 1,
                 backoff: float = 1.0, backoff_cap: float = 30.0,
                 poll_interval: float = 0.2,
                 clock: Callable[[], float] = time.time,
                 sleep: Callable[[float], None] = time.sleep,
                 log: Optional[Callable[[str], None]] = None):
        self.launch = launch
        self.output_dir = output_dir
        self.num_processes = int(num_processes)
        self.stall_timeout = stall_timeout
        self.max_restarts = int(max_restarts)
        self.shrink = bool(shrink)
        self.min_processes = max(1, int(min_processes))
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.poll_interval = poll_interval
        self._clock = clock
        self._sleep = sleep
        self._log = log if log is not None else (
            lambda msg: print(msg, file=sys.stderr, flush=True))
        self.restarts = 0
        self.width = self.num_processes
        self.widths_launched: List[int] = []

    def run(self) -> int:
        while True:
            self.widths_launched.append(self.width)
            procs = self.launch(self.width)
            mon = GangMonitor(procs, self.output_dir, self.width,
                              stall_timeout=self.stall_timeout,
                              clock=self._clock)
            verdict = None
            while verdict is None:
                self._sleep(self.poll_interval)
                verdict = mon.poll()
            if verdict["kind"] == "done":
                return 0
            mon.kill_gang()
            if self.restarts >= self.max_restarts:
                self._log(f"[elastic] giving up after {self.restarts} "
                          f"restarts: {verdict}")
                return 1
            self.restarts += 1
            dead = verdict.get("dead_ranks") or []
            if self.shrink and dead and len(dead) < self.width:
                new_width = max(self.min_processes, self.width - len(dead))
                if new_width != self.width:
                    self._log(f"[elastic] evicting dead rank(s) {dead} — "
                              f"resuming at width {new_width} (was "
                              f"{self.width})")
                    self.width = new_width
            delay = min(self.backoff_cap,
                        self.backoff * (2 ** (self.restarts - 1)))
            self._log(f"[elastic] gang failure {verdict} — restart "
                      f"{self.restarts}/{self.max_restarts} at width "
                      f"{self.width} from latest snapshot (backoff "
                      f"{delay:.1f}s)")
            if delay > 0:
                self._sleep(delay)
