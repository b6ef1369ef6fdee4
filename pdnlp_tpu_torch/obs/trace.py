"""Span tracer — where a step's time goes (``pdnlp_tpu/obs/trace.py``).

The tracer records host-side spans into a ring buffer:

- ``span(name, **attrs)`` — context manager; monotonic timestamps
  (``perf_counter``), thread-aware, nesting tracked through a per-thread
  stack so exporters can rebuild the call tree;
- **async-aware**: a CUDA launch returns at enqueue, so a span around a
  train step measures dispatch, not compute.  ``span("step_dispatch")``
  wraps the call, and ``Tracer.block(value)`` opens a SEPARATE
  ``device_block`` span that waits for ``value``'s producer and nothing
  more: an event recorded on the current stream, then synchronized.  On a
  disabled tracer ``block`` is a no-op, never a barrier;
- **ring buffer**: a ``deque(maxlen=capacity)`` of the most recent spans;
- **per-process files**: ``flush()`` writes ``trace_proc<i>.jsonl`` in
  the JAX package's record schema, clock-sync record included, so its
  ``trace_tpu.py`` and ``StepBreakdown.from_records`` read the file;
- **off by default**: a disabled tracer's ``span`` returns one shared
  no-op object;
- **on the profiler's clock**: while a ``torch.profiler`` is active each
  span also opens ``record_function("pdnlp.<name>")``, so a device trace
  shows the program's host spans beside its kernels (without a profiler:
  one flag check); ``flush``'s clock-sync record carries the profiler's
  clock (``profiler_ns``: Unix nanoseconds, as its events) read beside
  the tracer's;
- **device spans** (``device_span``; a tracer of a CUDA ``device``): marks
  the card writes itself, inside captured CUDA graphs too, decoded into
  records with ``device=True``, each with its optimizer ``step`` and
  ``layer`` (:mod:`~pdnlp_tpu_torch.obs.device`).  Disabled, or off the
  card, ``device_span`` returns the shared no-op: no library is built or
  loaded, no ring allocated, nothing enters a capture.

Listeners (``add_listener``) receive each finished record — how
:class:`~pdnlp_tpu_torch.obs.phases.StepBreakdown` and the
:class:`~pdnlp_tpu_torch.obs.regress.RegressionDetector` ride the stream.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

#: the meta record ``flush`` appends (tracer clock and wall clock read
#: back to back); the JAX package's ``obs/merge.py`` aligns ranks with it
CLOCK_SYNC = "_clock_sync"
#: the meta record of the device ring's counts ``flush`` appends: marks
#: logged, spans decoded, entries overwritten before they were read
#: (``overflow``) and entries the log did not expect (``mismatched``)
DEVICE_RING = "_device_ring"
#: prefix of the profiler ranges the spans open while a profiler is active
PROFILER_PREFIX = "pdnlp."

_profiler_on: Optional[Callable[[], bool]] = None


def _profiling() -> bool:
    """Is a ``torch.profiler`` recording (one flag check)?"""
    global _profiler_on
    if _profiler_on is None:
        import torch

        _profiler_on = torch.autograd._profiler_enabled
    return _profiler_on()


def wait_for(value) -> None:
    """Wait until the work that produced ``value`` (a tensor, or a dict /
    list / tuple of them) has run: an event recorded on the current stream
    of the value's card, synchronized.  CPU tensors are ready already."""
    import torch

    tensors = []

    def walk(v):
        if isinstance(v, torch.Tensor):
            tensors.append(v)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class Span:
    """One open span: ``with tracer.span("step_dispatch") as sp: ...``."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "_tid", "_depth",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> "Span":
        """Attach attributes after entry."""
        self.attrs.update(attrs)
        return self

    def block(self, value, name: str = "device_block", **attrs):
        """Wait for ``value`` inside a child span; returns ``value``."""
        return self._tracer.block(value, name=name, **attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        self._tid, stack = tr._thread_state()
        self._depth = len(stack)
        stack.append(self)
        self._range = None
        if _profiling():
            import torch

            self._range = torch.profiler.record_function(
                PROFILER_PREFIX + self.name)
            self._range.__enter__()
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        t1 = tr.clock()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _, stack = tr._thread_state()
        if stack and stack[-1] is self:
            stack.pop()
        tr._record(self.name, self.t0, t1, self._tid, self._depth, self.attrs)


class _NullSpan:
    """Shared no-op span of the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return self

    def block(self, value, name: str = "device_block", **attrs):
        return value        # tracing off never injects a barrier


_NULL_SPAN = _NullSpan()


class _DeviceSpan:
    """One device span: a begin mark at entry, an end mark at exit."""

    __slots__ = ("_dev", "_code", "_step")

    def __init__(self, dev, code: int, step: Optional[int]):
        self._dev = dev
        self._code = code
        self._step = step

    def __enter__(self):
        self._dev.mark(self._code, self._step)
        return self

    def __exit__(self, *exc) -> None:
        self._dev.mark(self._code + 1, self._step)


class Tracer:
    """Span recorder (module docstring).  ``enabled=False`` makes every call
    a near-free no-op."""

    def __init__(self, out_dir: Optional[str] = None, *,
                 enabled: bool = True, capacity: int = 100_000,
                 process_index: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device: Optional[str] = None, ring=None):
        self.enabled = bool(enabled)
        #: where the traced work runs: a CUDA device turns device spans on
        self.device = device
        #: do ``device_span`` and the model's marks record?  ``ring``
        #: stands in for the card's (tests); else one is made on first use
        self.device_spans = self.enabled and (
            ring is not None or str(device or "").startswith("cuda"))
        self._ring = ring
        self._dev = None
        self._dev_suspended = 0
        self.out_dir = out_dir
        self.capacity = int(capacity)
        self.clock = clock
        self.pid = process_index
        self._records: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}
        self._listeners: List[Callable[[Dict], None]] = []

    # --------------------------------------------------------------- spans
    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def block(self, value, name: str = "device_block", **attrs):
        """:func:`wait_for` ``value`` inside its own span; a no-op when
        disabled.  Returns ``value``."""
        if not self.enabled or value is None:
            return value
        with self.span(name, **attrs):
            wait_for(value)
        return value

    # -------------------------------------------------------- device spans
    def _device(self):
        """The :class:`~pdnlp_tpu_torch.obs.device.DeviceSpans`, made on
        first use (never under a capture: the ring is allocated and its
        clock read there); None where device spans are off."""
        if not self.device_spans or self._dev_suspended:
            return None
        if self._dev is None:
            from pdnlp_tpu_torch.obs import device as _device

            ring = self._ring
            if ring is None:
                import torch

                if torch.cuda.is_current_stream_capturing():
                    return None
                ring = _device.CudaRing(self.clock)
            self._dev = _device.DeviceSpans(ring, self._append)
        return self._dev

    def device_span(self, name: str, step: Optional[int] = None, **attrs):
        """Context manager: the card's own time from entry to exit, in
        stream order (``step``: the optimizer step the spans inside it
        belong to).  The shared no-op unless device spans are on."""
        dev = self._device()
        if dev is None:
            return _NULL_SPAN
        return _DeviceSpan(dev, dev.code(name, attrs, False), step)

    def device_mark(self, name: str, end: bool, **attrs) -> None:
        """One mark of the device span ``name``: its begin, or its end
        (``end``) — a boundary that no ``with`` block holds, such as a
        backward's (``obs.device.traced_call``)."""
        dev = self._device()
        if dev is not None:
            dev.mark(dev.code(name, attrs, end))

    def device_end_hook(self, param):
        """The post-accumulate-grad hook on ``param`` that ends a backward
        device span (``obs.device.traced_call``); None when off."""
        dev = self._device()
        return None if dev is None else dev.end_hook(param)

    @contextlib.contextmanager
    def device_capture(self, step: int):
        """Around a CUDA graph capture whose first train step is ``step``:
        yields the :class:`~pdnlp_tpu_torch.obs.device.Recording` of the
        marks captured inside (None when device spans are off), which
        :meth:`device_replay` logs at each replay."""
        dev = self._device()
        if dev is None:
            yield None
            return
        with dev.recording(step) as rec:
            yield rec

    def device_replay(self, rec, step: int) -> None:
        """Log a replay of the graph ``rec`` recorded, whose first step is
        ``step``; call it before the replay is launched."""
        if rec is not None and self._dev is not None:
            self._dev.replay(rec, step)

    @contextlib.contextmanager
    def device_suspended(self):
        """No device marks inside the block (work that is not a step of
        the run, such as a capture's warm-up step, which is undone)."""
        self._dev_suspended += 1
        try:
            yield
        finally:
            self._dev_suspended -= 1

    def drain_device(self) -> Optional[Dict[str, int]]:
        """Decode every device mark launched so far into records (waits
        for the card); the ring's counts, or None without device spans."""
        if self._dev is None:
            return None
        self._dev.drain()
        return self._dev.stats()

    def record(self, name: str, t0: float, t1: float, **attrs) -> None:
        """A span from explicit timestamps (the tracer's clock)."""
        if not self.enabled:
            return
        tid, stack = self._thread_state()
        self._record(name, t0, t1, tid, len(stack), attrs)

    def mark(self, name: str, attrs: Dict) -> None:
        """Zero-duration instant record, hot-path cheap: one clock read, no
        thread-state lookup (tid 0), the caller's dict adopted as it is —
        the per-request hop stream (``obs.request``) runs through here."""
        if not self.enabled:
            return
        rec = {"name": name, "t0": self.clock(), "dur": 0.0, "tid": 0,
               "depth": 0, "attrs": attrs}
        # under the lock: records()/flush() copy the deque under it, and a
        # concurrent lock-free append would break that copy
        with self._lock:
            self._records.append(rec)
        for fn in list(self._listeners):
            fn(rec)

    def now(self) -> float:
        return self.clock()

    def wrap_iter(self, name: str, it: Iterable, **attrs) -> Iterator:
        """Yield from ``it``, timing each ``next`` in a ``name`` span."""
        if not self.enabled:
            yield from it
            return
        it = iter(it)
        while True:
            with self.span(name, **attrs):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    # ----------------------------------------------------------- recording
    def _thread_state(self):
        local = self._local
        tid = getattr(local, "tid", None)
        if tid is None:
            ident = threading.get_ident()
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
            local.tid = tid
            local.stack = []
        return tid, local.stack

    def _record(self, name, t0, t1, tid, depth, attrs) -> None:
        rec = {"name": name, "t0": t0, "dur": t1 - t0, "tid": tid,
               "depth": depth}
        if attrs:
            rec["attrs"] = attrs
        self._append(rec)

    def _append(self, rec: Dict) -> None:
        with self._lock:
            self._records.append(rec)
        for fn in list(self._listeners):
            fn(rec)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._records)

    # ----------------------------------------------------------- listeners
    def add_listener(self, fn: Callable[[Dict], None]) -> None:
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Dict], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    # --------------------------------------------------------------- files
    def trace_path(self) -> Optional[str]:
        if not self.out_dir:
            return None
        return os.path.join(self.out_dir, f"trace_proc{self.pid or 0}.jsonl")

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        """Write the ring buffer as JSONL (one span per line), the device
        spans decoded first, plus the :data:`CLOCK_SYNC` record (and the
        :data:`DEVICE_RING` counts); returns the path, or None when there
        is nowhere to write.  The buffer is kept."""
        path = path or self.trace_path()
        if not self.enabled or path is None:
            return None
        from pdnlp_tpu_torch.obs.export import write_jsonl

        ring = self.drain_device()
        records = self.records()
        if ring is not None:
            records.append({"name": DEVICE_RING, "t0": self.clock(),
                            "dur": 0.0, "tid": 0, "depth": 0,
                            "attrs": ring})
        records.append({"name": CLOCK_SYNC, "t0": self.clock(), "dur": 0.0,
                        "tid": 0, "depth": 0,
                        "attrs": {"wall": time.time(),
                                  "profiler_ns": time.time_ns()}})
        write_jsonl(records, path, process_index=self.pid or 0)
        return path


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# process-global tracer: one configure() call at set-up turns every
# layer's spans on
_default = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _default


def configure(out_dir: Optional[str] = None, *, enabled: bool = True,
              capacity: int = 100_000,
              process_index: Optional[int] = None,
              device: Optional[str] = None) -> Tracer:
    """Replace the process-global tracer; identical settings keep the live
    one (and its spans).  A CUDA ``device`` turns device spans on."""
    global _default
    if process_index is None and enabled:
        process_index = _process_index()
    device = str(device) if device is not None and enabled else None
    same = (_default.enabled == enabled and _default.out_dir == out_dir
            and _default.capacity == int(capacity)
            and (_default.pid == process_index or not enabled)
            and _default.device == device)
    if not same:
        _default = Tracer(out_dir, enabled=enabled, capacity=capacity,
                          process_index=process_index, device=device)
    return _default


def configure_from_args(args) -> Tracer:
    """``--trace`` / ``--trace_dir`` -> the process-global tracer, with
    device spans on a ``--device cuda`` run.  ``trace=False`` resets it to
    disabled."""
    enabled = bool(getattr(args, "trace", False))
    out_dir = getattr(args, "trace_dir", None)
    if enabled and not out_dir:
        out_dir = os.path.join(getattr(args, "output_dir", "output"), "trace")
    return configure(out_dir if enabled else None, enabled=enabled,
                     device=getattr(args, "device", None))
