"""Device memory accounting (``pdnlp_tpu/obs/memory.py`` on
``torch.cuda.memory_stats``).

- :func:`device_memory_stats` — the caching allocator's counters per card
  (``allocated_bytes.all.current`` / ``.peak``, the card's total memory as
  the limit), or None on the CPU;
- :class:`MemorySampler` — samples at phase boundaries: attach
  :meth:`feed` as a tracer listener and every ``device_block`` / ``eval``
  / ``ckpt_save`` / ``ckpt_wait`` record triggers a read, tagged with the
  phase; samples land in the trace as zero-duration ``"hbm"`` records.  On
  the CPU the first sample flips ``supported=False`` and every later call
  is one attribute read.

Reads are host calls against the allocator's counters: no launch, no sync.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

#: tracer record name for memory samples (the JAX package's)
HBM_RECORD = "hbm"

#: phase records whose arrival triggers a listener-driven sample
SAMPLE_ON = ("device_block", "eval", "ckpt_save", "ckpt_wait")


def gb(nbytes: Optional[float]) -> Optional[float]:
    """Bytes -> GiB, rounded (None passes through)."""
    return None if nbytes is None else round(float(nbytes) / 2**30, 3)


def device_memory_stats(devices: Optional[Sequence] = None
                        ) -> Optional[List[Dict]]:
    """Per-card allocator counters, or None where there is no card.
    ``devices`` defaults to every visible card."""
    import torch

    if not torch.cuda.is_available():
        return None
    if devices is None:
        devices = range(torch.cuda.device_count())
    out = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(d)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        out.append({
            "device": int(d.index or 0),
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               in_use)),
            "bytes_limit": int(torch.cuda.get_device_properties(d)
                               .total_memory),
        })
    return out or None


def memory_snapshot(devices: Optional[Sequence] = None) -> Dict:
    """One-shot JSON-ready snapshot."""
    stats = device_memory_stats(devices)
    if stats is None:
        return {"supported": False}
    in_use = sum(s["bytes_in_use"] for s in stats)
    peak = sum(s["peak_bytes_in_use"] for s in stats)
    return {
        "supported": True,
        "devices": stats,
        "bytes_in_use": in_use,
        "peak_bytes_in_use": peak,
        "device_peak_bytes": max(s["peak_bytes_in_use"] for s in stats),
        "gb_in_use": gb(in_use),
        "gb_peak": gb(peak),
    }


class MemorySampler:
    """Phase-boundary memory sampler (module docstring) over every visible
    card.  ``tracer`` (optional): samples also land as ``"hbm"`` records.
    ``stats`` (a ``device_memory_stats``-like callable) replaces the
    allocator read in tests."""

    def __init__(self, *, tracer=None,
                 stats: Optional[Callable[[], Optional[List[Dict]]]] = None):
        self._tracer = tracer
        self._stats = stats or device_memory_stats
        self._lock = threading.Lock()
        self.supported: Optional[bool] = None
        self.bytes_in_use = 0
        self.peak_bytes = 0
        self.device_peak_bytes = 0
        self.samples = 0
        self.per_phase: Dict[str, Dict[str, int]] = {}
        self._last_devices: Optional[List[Dict]] = None

    def sample(self, phase: Optional[str] = None) -> Optional[Dict]:
        """Read the counters once; the aggregate dict, or None where
        unsupported.  ``phase`` tags the per-phase peak table."""
        if self.supported is False:
            return None
        stats = self._stats()
        if stats is None:
            self.supported = False
            return None
        in_use = sum(s["bytes_in_use"] for s in stats)
        peak = sum(s["peak_bytes_in_use"] for s in stats)
        dev_peak = max(s["peak_bytes_in_use"] for s in stats)
        with self._lock:
            self.supported = True
            self.samples += 1
            self._last_devices = stats
            self.bytes_in_use = in_use
            self.peak_bytes = max(self.peak_bytes, peak)
            self.device_peak_bytes = max(self.device_peak_bytes, dev_peak)
            if phase:
                p = self.per_phase.setdefault(
                    phase, {"bytes_in_use": 0, "peak_bytes": 0, "samples": 0})
                p["bytes_in_use"] = max(p["bytes_in_use"], in_use)
                p["peak_bytes"] = max(p["peak_bytes"], peak)
                p["samples"] += 1
        agg = {"bytes_in_use": in_use, "peak_bytes": peak,
               "device_peak_bytes": dev_peak}
        tr = self._tracer
        if tr is not None and tr.enabled:
            t = tr.now()
            tr.record(HBM_RECORD, t, t, phase=phase, **agg)
        return agg

    def feed(self, record: Dict) -> None:
        """Tracer-listener form: sample at :data:`SAMPLE_ON` records."""
        if record.get("name") in SAMPLE_ON:
            self.sample(phase=record["name"])

    def snapshot(self, sample: bool = True) -> Dict:
        """JSON-ready state; ``sample`` refreshes the counters first."""
        if sample:
            self.sample()
        with self._lock:
            if not self.supported:
                return {"supported": False}
            return {
                "supported": True,
                "bytes_in_use": self.bytes_in_use,
                "peak_bytes_in_use": self.peak_bytes,
                "device_peak_bytes": self.device_peak_bytes,
                "gb_in_use": gb(self.bytes_in_use),
                "gb_peak": gb(self.peak_bytes),
                "samples": self.samples,
                "per_phase": {
                    phase: {**p, "gb_peak": gb(p["peak_bytes"])}
                    for phase, p in sorted(self.per_phase.items())
                },
                "devices": self._last_devices,
            }

    def beat_payload(self) -> Dict:
        """The heartbeat's memory fields (empty where unsupported)."""
        if not self.supported:
            return {}
        return {"hbm": self.bytes_in_use, "hbm_peak": self.peak_bytes}
