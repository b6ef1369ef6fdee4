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
  is one attribute read;
- :class:`KVBudget` — the declared ``--kv_hbm_mb`` budget of one decode
  engine's KV cache: it caps the preallocation at construction and
  refuses an oversized stream at admission, both loudly
  (:class:`KVBudgetExceeded`), and carries the live-bytes gauge.  The
  bytes it counts are the cache tensors the engine allocates on the card;
  what the card's allocator holds in all is :func:`device_memory_stats`'s.

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


class KVBudgetExceeded(RuntimeError):
    """A generative stream (or a decode engine's cache preallocation) would
    exceed the declared ``--kv_hbm_mb`` KV budget — the loud refusal that
    replaces an allocator OOM three layers deeper."""


class KVBudget:
    """Declared KV-cache budget for one decode engine
    (``pdnlp_tpu/obs/memory.py``'s, with the guard counted).

    The engine preallocates its cache once (slots or pages, updated in
    place — decode never allocates), so the budget decides at two doors:

    - **construction**: :meth:`cap_slots` / :meth:`cap_pages` return how
      many slots or pages the budget covers — the engine allocates that
      many (noted on stderr when capped below the request) and refuses
      outright when not even one maximum-length stream fits.  The port's
      engines allocate guard storage beside what they serve (a guard
      slot, or the zero and sink pages: ``models.decoder``), and the
      ``guard`` argument charges it to the same budget, so the whole
      allocation stays under ``--kv_hbm_mb``;
    - **admission**: :meth:`check_stream` refuses a stream whose worst
      case (``prompt + max_new_tokens`` positions) cannot fit.

    :meth:`set_live` / :attr:`live_bytes` is the ``/metrics`` gauge:
    positions actually written across live streams x bytes per position.
    ``budget_mb`` 0 or None disables every check and keeps the gauge."""

    def __init__(self, budget_mb: Optional[float] = None):
        self.budget_bytes: Optional[int] = (
            None if not budget_mb else int(float(budget_mb) * 2**20))
        self._live = 0
        self._lock = threading.Lock()

    def cap_slots(self, requested: int, slot_bytes: int,
                  guard: int = 0) -> int:
        """Slots the budget covers (``requested`` when unbudgeted); raises
        :class:`KVBudgetExceeded` when it cannot cover one.  ``guard``
        slots the engine allocates beside the served ones (never served)
        are paid out of the same budget."""
        if self.budget_bytes is None:
            return int(requested)
        fit = self.budget_bytes // max(1, int(slot_bytes)) - int(guard)
        if fit < 1:
            raise KVBudgetExceeded(
                f"kv_hbm_mb={self.budget_bytes / 2**20:.1f} cannot hold "
                f"even one decode slot ({slot_bytes / 2**20:.1f} MB of KV "
                f"at this max_len/model, {guard} guard slot(s) paid first) "
                "— raise --kv_hbm_mb or shrink "
                "--decode_max_len")
        return min(int(requested), int(fit))

    def cap_pages(self, requested: int, page_bytes: int,
                  min_pages: int = 1, guard: int = 0) -> int:
        """Pages the budget covers (``requested`` when unbudgeted);
        ``min_pages`` is one maximum-length stream's pages — a budget that
        cannot cover it refuses here instead of deadlocking every claim.
        ``guard`` pages (allocated beside the pool, never handed out) are
        paid out of the same budget."""
        if self.budget_bytes is None:
            return int(requested)
        fit = self.budget_bytes // max(1, int(page_bytes)) - int(guard)
        if fit < int(min_pages):
            raise KVBudgetExceeded(
                f"kv_hbm_mb={self.budget_bytes / 2**20:.1f} covers only "
                f"{max(fit, 0)} KV pages ({page_bytes / 2**20:.2f} MB/page, "
                f"{guard} guard pages paid first) but "
                f"one maximum-length stream needs {min_pages} — raise "
                "--kv_hbm_mb or shrink --decode_max_len/--kv_page_sz")
        return min(int(requested), int(fit))

    def check_stream(self, tokens_total: int, token_bytes: int) -> None:
        """Admission door: refuse a stream whose worst-case KV cannot fit
        under the budget."""
        if self.budget_bytes is None:
            return
        need = int(tokens_total) * int(token_bytes)
        if need > self.budget_bytes:
            raise KVBudgetExceeded(
                f"stream needs {need / 2**20:.1f} MB of KV "
                f"({tokens_total} positions) but the declared budget is "
                f"{self.budget_bytes / 2**20:.1f} MB (--kv_hbm_mb) — "
                "shorten the prompt / max_new_tokens or raise the budget")

    def set_live(self, nbytes: int) -> None:
        with self._lock:
            self._live = int(nbytes)

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return self._live

    def snapshot(self) -> Dict:
        """JSON-ready block for engine snapshots and the exporter."""
        with self._lock:
            live = self._live
        return {
            "budget_mb": (None if self.budget_bytes is None
                          else round(self.budget_bytes / 2**20, 3)),
            "live_bytes": live,
            "live_mb": round(live / 2**20, 3),
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
