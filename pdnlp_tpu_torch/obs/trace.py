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
  no-op object.

Listeners (``add_listener``) receive each finished record — how
:class:`~pdnlp_tpu_torch.obs.phases.StepBreakdown` and the
:class:`~pdnlp_tpu_torch.obs.regress.RegressionDetector` ride the stream.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

#: the meta record ``flush`` appends (tracer clock and wall clock read
#: back to back); the JAX package's ``obs/merge.py`` aligns ranks with it
CLOCK_SYNC = "_clock_sync"


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

    __slots__ = ("_tracer", "name", "attrs", "t0", "_tid", "_depth")

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
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> None:
        tr = self._tracer
        t1 = tr.clock()
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


class Tracer:
    """Span recorder (module docstring).  ``enabled=False`` makes every call
    a near-free no-op."""

    def __init__(self, out_dir: Optional[str] = None, *,
                 enabled: bool = True, capacity: int = 100_000,
                 process_index: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
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
        """Write the ring buffer as JSONL (one span per line) plus the
        :data:`CLOCK_SYNC` record; returns the path, or None when there is
        nowhere to write.  The buffer is kept."""
        path = path or self.trace_path()
        if not self.enabled or path is None:
            return None
        from pdnlp_tpu_torch.obs.export import write_jsonl

        records = self.records()
        records.append({"name": CLOCK_SYNC, "t0": self.clock(), "dur": 0.0,
                        "tid": 0, "depth": 0,
                        "attrs": {"wall": time.time()}})
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
              process_index: Optional[int] = None) -> Tracer:
    """Replace the process-global tracer; identical settings keep the live
    one (and its spans)."""
    global _default
    if process_index is None and enabled:
        process_index = _process_index()
    same = (_default.enabled == enabled and _default.out_dir == out_dir
            and _default.capacity == int(capacity)
            and (_default.pid == process_index or not enabled))
    if not same:
        _default = Tracer(out_dir, enabled=enabled, capacity=capacity,
                          process_index=process_index)
    return _default


def configure_from_args(args) -> Tracer:
    """``--trace`` / ``--trace_dir`` -> the process-global tracer.
    ``trace=False`` resets it to disabled."""
    enabled = bool(getattr(args, "trace", False))
    out_dir = getattr(args, "trace_dir", None)
    if enabled and not out_dir:
        out_dir = os.path.join(getattr(args, "output_dir", "output"), "trace")
    return configure(out_dir if enabled else None, enabled=enabled)
