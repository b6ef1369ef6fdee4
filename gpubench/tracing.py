"""Reading the profiler's trace of the traced slice: which operations ran
on the device and when, how much of the slice the device was busy, and
what the host was doing in the longest idle gaps.

The slice is one ``record_function`` range (:data:`ACTIVE`) opened and
closed right after a device synchronize, so every device operation of its
steps lies inside it.  The benchmark's own spans (``gpubench.*`` ranges on
the host) label the gaps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

ACTIVE = "gpubench.active"
SPAN_PREFIX = "gpubench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    steps: int
    #: (name, start_s, end_s) of every device operation inside the slice,
    #: relative to the slice's start
    ops: List[Tuple[str, float, float]]
    #: (label, start_s, end_s) of the benchmark's host spans in the slice
    spans: List[Tuple[str, float, float]]

    def device_seconds(self, *fragments: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``fragments`` (lower case)."""
        return sum(e - s for n, s, e in self.ops
                   if any(f in n.lower() for f in fragments))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def gaps(self) -> List[Tuple[float, float]]:
        """Stretches of the slice with no device operation running."""
        out, t = [], 0.0
        for s, e in _merged((s, e) for _n, s, e in self.ops):
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            out.append((t, self.window_s))
        return out

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps, each named by the host span that was
        open at its start (the innermost one), else ``host``."""
        out = []
        for s, e in sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]:
            label = "host"
            inner = None
            for name, a, b in self.spans:
                if a <= s < b and (inner is None or b - a < inner):
                    label, inner = name, b - a
            out.append([label, e - s])
        return out


def _merged(intervals):
    cur = None
    for s, e in sorted(intervals):
        if cur is None or s > cur[1]:
            if cur is not None:
                yield cur
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        yield cur


def read(prof, steps: int) -> Optional[Trace]:
    """The :class:`Trace` of the profiler's :data:`ACTIVE` range, or None
    where the trace holds no such range or no device operation."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    active = [e for e in events if e.name() == ACTIVE
              and e.device_type() == DeviceType.CPU]
    if not active:
        return None
    a0, a1 = active[0].start_ns(), active[0].end_ns()
    ops, spans = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith(SPAN_PREFIX) and e.name() != ACTIVE \
                    and s < a1 and t > a0:
                spans.append((e.name()[len(SPAN_PREFIX):],
                              (max(s, a0) - a0) / 1e9,
                              (min(t, a1) - a0) / 1e9))
            continue
        if e.is_user_annotation() or t <= a0 or s >= a1:
            continue
        ops.append((e.name(), (max(s, a0) - a0) / 1e9,
                    (min(t, a1) - a0) / 1e9))
    if not ops:
        return None
    busy = sum(e - s for s, e in _merged((s, e) for _n, s, e in ops))
    return Trace((a1 - a0) / 1e9, busy, steps, ops, spans)
