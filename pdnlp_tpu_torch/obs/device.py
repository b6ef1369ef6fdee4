"""Device spans: the card's own time of a span, inside captured CUDA
graphs too (the port's addition to :mod:`~pdnlp_tpu_torch.obs.trace`; the
JAX package reads its device time from the XLA profiler, which splits a
jitted step by op).

A captured group replays as one flat stream of kernels and runs no host
code, so a host span cannot say which step or layer a replay's device
time belongs to.  A device span is two **marks**: one-thread kernels
(``csrc/trace_mark.cu``) launched on the current stream before and after
the work, and so captured into a graph between its neighbours.  A mark
claims the next slot of a device ring with an ``atomicAdd`` on a device
counter and writes the card's ``%globaltimer`` and its code there, so
every replay writes fresh entries and nothing is synchronized to write
them.

The host keeps the **dispatch log**: for each eager mark its code (and the
step a ``step`` span carries), for each replay the marks its capture
recorded (:class:`Recording`) and the replay's first step.  Marks run in
stream order, so slot order is log order: the host reads the ring lazily
(an async copy of the new entries behind an event it only queries,
:meth:`DeviceSpans.poll`; a blocking :meth:`DeviceSpans.drain` at the
tracer's ``flush``) and walks it alongside the log, which gives each
entry its span, its layer and its optimizer step.  Entries a later mark
overwrote before they were copied are counted (``overflow``) and their
spans dropped, never decoded from a wrapped slot; an entry whose code is
not the one the log expects is counted (``mismatched``) and dropped.

Backward boundaries are marked from gradient hooks and identity nodes
(:func:`traced_call`), which change no value and no order of a sum, so
forward and gradients keep their bits.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: entries of a tracer's ring (16 bytes each: 1 MiB on the card); the host
#: copies the new ones out at every replay and every quarter of it eagerly
RING_CAPACITY = 1 << 16
#: the ``tid`` of device span records: the card's track in an export
DEVICE_TID = -1


class CudaRing:
    """The ring on the current card: ``[capacity, 2]`` int64 entries
    (``time_ns``, code) and the counter, their pinned host copies and the
    mark library.  ``offset_s`` puts a mark's ``%globaltimer`` seconds on
    ``clock`` (read back to back with one clock kernel, at set-up)."""

    def __init__(self, clock: Callable[[], float],
                 capacity: int = RING_CAPACITY):
        from pdnlp_tpu_torch.ops import cuda_lib

        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"the ring's capacity must be a power of two, "
                             f"got {capacity}")
        P, L = ctypes.c_void_p, ctypes.c_longlong
        self._lib = cuda_lib.bind("trace_mark", {
            "pdnlp_trace_mark": (ctypes.c_int, [P, P, L, L, P]),
            "pdnlp_trace_clock": (ctypes.c_int, [P, P]),
            "pdnlp_trace_mark_error_string": (ctypes.c_char_p,
                                              [ctypes.c_int]),
        }).lib
        self.capacity = capacity
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.ring = torch.zeros((capacity, 2), dtype=torch.int64,
                                device=self.device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._host = torch.empty((capacity, 2), dtype=torch.int64
                                 ).pin_memory()
        self._host_counter = torch.empty(1, dtype=torch.int64).pin_memory()
        self._event = torch.cuda.Event()
        self._copying = 0
        self.offset_s = self._offset(clock)

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def _check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(
                "trace mark launch failed: "
                + self._lib.pdnlp_trace_mark_error_string(err).decode())

    def _offset(self, clock) -> float:
        out = torch.zeros(1, dtype=torch.int64, device=self.device)
        torch.cuda.synchronize(self.device)
        t0 = clock()
        self._check(self._lib.pdnlp_trace_clock(out.data_ptr(),
                                                self._stream()))
        torch.cuda.synchronize(self.device)
        t1 = clock()
        return (t0 + t1) / 2 - out.item() / 1e9

    def capturing(self) -> bool:
        return torch.cuda.is_current_stream_capturing()

    def launch(self, code: int) -> None:
        """One mark on the current stream (captured, under a capture)."""
        self._check(self._lib.pdnlp_trace_mark(
            self.ring.data_ptr(), self.counter.data_ptr(), self.capacity,
            code, self._stream()))

    def start_copy(self, first: int, count: int) -> None:
        """Copy entries ``[first, first + count)`` and the counter to the
        host on the current stream, behind an event (``count`` at most
        the capacity)."""
        s = first & (self.capacity - 1)
        n = min(count, self.capacity - s)
        self._host[:n].copy_(self.ring[s:s + n], non_blocking=True)
        if count > n:
            self._host[n:count].copy_(self.ring[:count - n],
                                      non_blocking=True)
        self._host_counter.copy_(self.counter, non_blocking=True)
        self._event.record()
        self._copying = count

    def ready(self) -> bool:
        return self._event.query()

    def wait(self) -> None:
        self._event.synchronize()

    def copied(self) -> Tuple[int, Sequence]:
        """(the counter, the copied ``[count, 2]`` entries) of the last
        copy, once it is done."""
        return (int(self._host_counter.numpy()[0]),
                self._host[:self._copying].numpy().copy())


class Recording:
    """The marks one capture recorded, in order, as ``(code, step offset
    from the capture's first step or None)``, and the ring they write to
    at every replay (held here: the graph's kernels write to it)."""

    def __init__(self, ring, step: int):
        self.ring = ring
        self.step = step
        self.marks: List[Tuple[int, Optional[int]]] = []


class _EndOnGrad:
    """A parameter's post-accumulate-grad hook: fires the backward-end
    mark armed by the span's backward begin, once."""

    def __init__(self):
        self.armed: Optional[Callable[[], None]] = None

    def __call__(self, _param) -> None:
        fire, self.armed = self.armed, None
        if fire is not None:
            fire()


class DeviceSpans:
    """One tracer's device spans: the table of span names and attributes
    (a mark's code is ``2 * index + end``), the dispatch log, the drain
    and the decoder (module docstring).  ``emit(record)`` receives each
    decoded span."""

    def __init__(self, ring, emit: Callable[[Dict], None]):
        self.ring = ring
        self._emit = emit
        self._lock = threading.RLock()
        self.table: List[Tuple[str, Dict]] = []
        self._codes: Dict[tuple, int] = {}
        #: [marks, first step (replays) or 0, marks already read]
        self._log: collections.deque = collections.deque()
        self.enqueued = 0           # marks launched, replays' included
        self._copied = 0            # marks a copy was started for
        self._copy: Optional[Tuple[int, int]] = None   # (first, lost)
        self.overflow = 0
        self.mismatched = 0
        self.decoded = 0
        self._open: Dict[int, List[tuple]] = {}
        #: the step the marks now launched belong to
        self._step: Optional[int] = None
        self._depth = 0
        self._recording: Optional[Recording] = None
        self._hooks: Dict[int, tuple] = {}

    # ----------------------------------------------------------- marking
    def code(self, name: str, attrs: Dict, end: bool) -> int:
        key = (name, tuple(sorted(attrs.items())))
        with self._lock:
            sid = self._codes.get(key)
            if sid is None:
                sid = self._codes[key] = len(self.table)
                self.table.append((name, dict(attrs)))
        return 2 * sid + int(end)

    def mark(self, code: int, step: Optional[int] = None) -> None:
        """Launch one mark and log it with the optimizer step it belongs
        to (``step`` on both marks of a span that carries one, such as
        ``step``: the marks between them belong to it); under a capture it
        goes into the open :class:`Recording` (or nowhere: a capture of
        another caller's, whose replays this log could not follow)."""
        with self._lock:
            if step is None:
                step = self._step
            else:               # the begin or end of a span with a step
                self._step = None if code & 1 else step
            if self.ring.capturing():
                rec = self._recording
                if rec is not None:
                    rec.marks.append((code, None if step is None
                                      else step - rec.step))
                    self.ring.launch(code)
                return
            self.ring.launch(code)
            self._log.append([((code, step),), 0, 0])
            self.enqueued += 1
            if self.enqueued - self._copied >= self.ring.capacity // 4:
                self.poll()

    @contextlib.contextmanager
    def recording(self, step: int):
        """The marks of the capture inside the block, ``step`` being the
        optimizer step its first train step takes."""
        rec = Recording(self.ring, step)
        with self._lock:
            self._recording = rec
        try:
            yield rec
        finally:
            with self._lock:
                self._recording = None

    def replay(self, rec: Optional[Recording], step: int) -> None:
        """Log a replay of ``rec``'s graph whose first step is ``step``
        (before the replay is launched)."""
        if rec is None or rec.ring is not self.ring or not rec.marks:
            return
        with self._lock:
            self.poll()         # a copy now runs before the replay's marks
            self._log.append([tuple(rec.marks), step, 0])
            self.enqueued += len(rec.marks)

    def end_hook(self, param) -> _EndOnGrad:
        """The post-accumulate-grad hook on ``param`` (registered once)."""
        with self._lock:
            held = self._hooks.get(id(param))
            if held is None or held[0] is not param:
                hook = _EndOnGrad()
                held = (param, hook, param.register_post_accumulate_grad_hook(
                    hook))
                self._hooks[id(param)] = held
            return held[1]

    # ---------------------------------------------------------- draining
    def poll(self, block: bool = False) -> None:
        """Decode the copy in flight once it is done (``block``: wait for
        it), then start a copy of the entries logged since; never under a
        capture."""
        with self._lock:
            ring = self.ring
            if ring.capturing():
                return
            if self._copy is not None:
                if not block and not ring.ready():
                    return
                ring.wait()
                first, lost = self._copy
                self._copy = None
                counter, entries = ring.copied()
                self._decode(first, lost, counter, entries)
            if self.enqueued > self._copied:
                first = max(self._copied, self.enqueued - ring.capacity)
                ring.start_copy(first, self.enqueued - first)
                self._copy = (first, first - self._copied)
                self._copied = self.enqueued

    def drain(self) -> None:
        """Decode every mark logged so far (waits for the card)."""
        with self._lock:
            self.poll(block=True)
            self.poll(block=True)

    # ---------------------------------------------------------- decoding
    def _take(self, n: int) -> List[Tuple[int, Optional[int]]]:
        """The next ``n`` marks of the log, as ``(code, step or None)``."""
        out: List[Tuple[int, Optional[int]]] = []
        while len(out) < n and self._log:
            chunk = self._log[0]
            marks, step, taken = chunk
            k = min(n - len(out), len(marks) - taken)
            out += [(c, None if off is None else step + off)
                    for c, off in marks[taken:taken + k]]
            chunk[2] += k
            if chunk[2] == len(marks):
                self._log.popleft()
        return out

    def _decode(self, first: int, lost: int, counter: int,
                entries) -> None:
        expected = self._take(lost + len(entries))
        self.overflow += lost
        self.mismatched += abs(counter - (first + len(entries)))
        for (t_ns, code), (want, step) in zip(entries, expected[lost:]):
            if int(code) != want:
                self.mismatched += 1
                continue
            self._pair(int(t_ns), want, step)

    def _pair(self, t_ns: int, code: int, step: Optional[int]) -> None:
        sid, end = divmod(code, 2)
        if not end:
            self._open.setdefault(sid, []).append((t_ns, step, self._depth))
            self._depth += 1
            return
        opened = self._open.get(sid)
        if not opened:                 # its begin was overwritten
            return
        t0, step0, depth = opened.pop()
        self._depth = depth
        name, attrs = self.table[sid]
        if step0 is not None:
            attrs = dict(attrs, step=step0)
        self.decoded += 1
        self._emit({"name": name, "t0": t0 / 1e9 + self.ring.offset_s,
                    "dur": (t_ns - t0) / 1e9, "tid": DEVICE_TID,
                    "depth": depth, "attrs": dict(attrs), "device": True})

    def stats(self) -> Dict[str, int]:
        return {"marks": self.enqueued, "spans": self.decoded,
                "overflow": self.overflow, "mismatched": self.mismatched}


# --------------------------------------------------------- the model sites


class _AfterGrads:
    """A tensor gradient hook that calls ``fire`` once ``n`` of the
    gradients it is registered on have been computed; it returns None, so
    every gradient passes on unchanged."""

    def __init__(self, n: int, fire: Callable[[], None]):
        self.left = n
        self.fire = fire

    def __call__(self, _grad) -> None:
        self.left -= 1
        if self.left == 0:
            self.fire()


class _GradMark(torch.autograd.Function):
    """Identity; its backward calls ``fire`` as soon as the gradients of
    all its outputs are in, and passes them on unchanged."""

    @staticmethod
    def forward(ctx, fire, *xs):
        ctx.fire = fire
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.fire()
        return (None, *grads)


def traced_call(tracer, name: str, fn: Callable, inputs: Sequence = (),
                end_on=None, **attrs):
    """``fn(*inputs)`` inside the device span ``<name>.fwd``, and its
    backward inside ``<name>.bwd``: from the gradients of all its outputs
    (a hook on each) to where its own gradients are done, which is

    - without ``end_on``: the gradients of all ``inputs``, taken by an
      identity node on them that ``fn`` alone reads (so it runs as soon as
      ``fn``'s backward has produced them, and no sum of gradients changes
      order);
    - ``end_on`` a leaf parameter: the accumulation of its gradient (a
      post-accumulate-grad hook);
    - ``end_on`` another tensor: the moment its whole gradient is in (a
      hook on it: for an input that other operations read too).

    The forward and every gradient keep their bits.  Off the card, with
    the tracer off or without autograd, just ``fn(*inputs)``."""
    if not (tracer.device_spans and torch.is_grad_enabled()):
        return fn(*inputs)
    bwd = name + ".bwd"

    def end():
        tracer.device_mark(bwd, True, **attrs)

    hook = None
    if end_on is None:
        if any(t.requires_grad for t in inputs):
            inputs = _GradMark.apply(end, *inputs)
        else:
            end = None
    elif end_on.is_leaf:
        hook = tracer.device_end_hook(end_on) if end_on.requires_grad \
            else None
        end = None if hook is None else end
    elif end_on.requires_grad:
        end_on.register_hook(_AfterGrads(1, end))
    else:
        end = None
    with tracer.device_span(name + ".fwd", **attrs):
        out = fn(*inputs)
    outs = [t for t in (out if isinstance(out, tuple) else (out,))
            if t.requires_grad]
    if end is None or not outs:
        return out

    def begin():
        tracer.device_mark(bwd, False, **attrs)
        if hook is not None:
            hook.armed = end

    after_outputs = _AfterGrads(len(outs), begin)
    for t in outs:
        t.register_hook(after_outputs)
    return out
