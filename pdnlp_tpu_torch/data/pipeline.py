"""Input pipeline: how training batches reach the card
(``pdnlp_tpu/data/pipeline.py``).

Three modes behind one interface (:func:`build_pipeline`,
``--pipeline auto|resident|prefetch|sync``):

- ``"resident"``: the encoded split is uploaded to the card once, and each
  epoch uploads its permutation once.  A step is then an ``index_select``
  per channel plus the bucket's column slice, on the card: no host copy
  and no upload inside the loop.  Every channel carries one extra all-zero
  row that the filler slots of a short batch gather, so the batches are
  the host loader's bytes.  The default when the loader holds an
  ``EncodedDataset``, it fits ``--pipeline_hbm_mb`` and the run is one
  process.
- ``"prefetch"``: a worker thread pins batch k+1 and uploads it on a side
  CUDA stream while step k runs, with at most one batch in flight.  The
  compute stream waits on an event recorded after the copy, and every
  uploaded tensor is recorded on the compute stream, so the caching
  allocator cannot hand its memory out while the step still reads it.
- ``"sync"``: the upload inline in the loop.

Every mode feeds the ``Trainer`` through ``macro_batches(fuse, stage)``,
which yields ``(device_batch, n_steps, fused, examples)``; ``examples`` is
counted on the host, so the loop never reads a device value to count.
With ``fuse`` = K > 1, runs of K same-width batches come as one fused
group ``[K, rows, ...]`` (a bucket boundary flushes a partial run as single
steps: widths are never stacked together), the rest as single steps.  A
fused group lands in ``stage``'s static device buffers, one set per shape
signature (:class:`DeviceStage`, the buffers a captured step graph reads),
copied in on the current stream — the one that replays the graph — never
through a fresh tensor: sync uploads the pinned host stack into them,
prefetch copies its side-stream upload in, resident ``index_select``s
into them on the card.  Each pipeline records
:class:`~pdnlp_tpu_torch.utils.metrics.TransportStats` and ``h2d_put``
spans on the obs tracer (the resident pipeline's one-time uploads with
``in_loop=False``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from pdnlp_tpu_torch.utils.metrics import TransportStats

Batch = Dict[str, np.ndarray]
Step = Tuple[Dict[str, torch.Tensor], int, bool, int]


def to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device``: on the card a pinned host copy,
    then an asynchronous upload on the current stream."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in batch.items()}
    if device.type != "cuda":
        return tensors
    return {k: t.pin_memory().to(device, non_blocking=True)
            for k, t in tensors.items()}


def _nbytes(batch: Batch) -> int:
    return sum(v.nbytes for v in batch.values())


def _batch_record(host: Batch) -> Tuple[int, int, dict]:
    """(examples, label slots, token counts) of a host batch."""
    w = host["example_weight"]
    return int(w.sum()), int(w.size), {
        "seq_len": int(host["input_ids"].shape[-1]),
        "tokens": int(host["input_ids"].size),
        "tokens_real": int(host["attention_mask"].sum())}


def resident_arrays(encoded) -> Dict[str, np.ndarray]:
    """What the resident pipeline holds on the card: the encoded split,
    a per-example weight of 1 where the split has none (packed rows carry
    their own), and one all-zero row at index ``len(encoded)`` that filler
    slots gather."""
    arrays = dict(encoded.arrays)
    if "example_weight" not in arrays:
        arrays["example_weight"] = np.ones((len(encoded),), np.float32)
    return {k: np.concatenate([v, np.zeros((1,) + v.shape[1:], v.dtype)])
            for k, v in arrays.items()}


def resident_nbytes(encoded) -> int:
    """The bytes of :func:`resident_arrays`, from the shapes alone: what
    ``--pipeline_hbm_mb`` is held against."""
    arrays = encoded.arrays
    total = 0 if "example_weight" in arrays else (len(encoded) + 1) * 4
    for v in arrays.values():
        total += v.nbytes + v.itemsize * int(np.prod(v.shape[1:]))
    return total


def _tracer():
    from pdnlp_tpu_torch.obs.trace import get_tracer

    return get_tracer()


def _seq_of(batch) -> int:
    return int(batch["input_ids"].shape[-1])


class _MacroStage:
    """Host staging for K-stacked groups (``pdnlp_tpu/data/pipeline.py``):
    buffers allocated once per shape signature and reused, ping-ponging
    between two so the group yielded before stays whole one more
    iteration.  Sound because every consumer copies the group out before
    it advances (the sync upload pins a copy)."""

    def __init__(self, k: int):
        self.k = int(k)
        self._bufs: dict = {}
        self._i: dict = {}

    @staticmethod
    def _sig(batch: Batch) -> tuple:
        return tuple(sorted((key, v.shape, str(v.dtype))
                            for key, v in batch.items()))

    def stack(self, group: List[Batch]) -> Batch:
        """One ``[K, ...]`` host group from ``k`` host batches."""
        sig = self._sig(group[0])
        if sig not in self._bufs:
            def alloc():
                return {key: np.empty((self.k,) + v.shape, v.dtype)
                        for key, v in group[0].items()}
            self._bufs[sig] = (alloc(), alloc())
            self._i[sig] = 0
        buf = self._bufs[sig][self._i[sig]]
        self._i[sig] ^= 1
        for i, b in enumerate(group):
            for key in buf:
                np.copyto(buf[key][i], b[key])
        return buf


def host_macro_batches(loader, k: int, stage: Optional[_MacroStage] = None
                       ) -> Iterator[Tuple[Batch, int, bool, int]]:
    """``(host_batch, n_steps, fused, examples)``: runs of ``k`` loader
    batches stacked on a leading step axis, the rest as singles.  Fusion
    is shape-homogeneous: a width change flushes the partial run as single
    steps, so each width has one group shape.  A group staged through
    ``stage`` is valid until the next iteration."""
    if k <= 1:
        for b in loader:
            yield b, 1, False, int(b["example_weight"].sum())
        return
    stage = stage or _MacroStage(k)
    buf: List[Batch] = []
    for b in loader:
        if buf and _seq_of(b) != _seq_of(buf[0]):
            for x in buf:
                yield x, 1, False, int(x["example_weight"].sum())
            buf = []
        buf.append(b)
        if len(buf) == k:
            ex = sum(int(x["example_weight"].sum()) for x in buf)
            yield stage.stack(buf), k, True, ex
            buf = []
    for b in buf:
        yield b, 1, False, int(b["example_weight"].sum())


_TORCH_DTYPE = {np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32}


class DeviceStage:
    """Static device buffers for fused groups, one set per shape signature
    (``((key, shape, dtype), ...)``), allocated at first use and reused for
    every later group of that shape: the tensors a captured step graph
    reads.  Shared by the pipeline (which fills them) and the multi-step
    (which captures on them)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._bufs: Dict[tuple, Dict[str, torch.Tensor]] = {}

    @staticmethod
    def signature(spec: Dict[str, Tuple[tuple, torch.dtype]]) -> tuple:
        return tuple(sorted((k, tuple(s), str(d)) for k, (s, d)
                            in spec.items()))

    def buffers(self, spec: Dict[str, Tuple[tuple, torch.dtype]]
                ) -> Dict[str, torch.Tensor]:
        sig = self.signature(spec)
        if sig not in self._bufs:
            self._bufs[sig] = {k: torch.empty(s, dtype=d, device=self.device)
                               for k, (s, d) in spec.items()}
        return self._bufs[sig]

    def like(self, batch) -> Dict[str, torch.Tensor]:
        """The buffers shaped like ``batch`` (host arrays or tensors)."""
        return self.buffers({
            k: (tuple(v.shape), v.dtype if isinstance(v, torch.Tensor)
                else _TORCH_DTYPE.get(np.dtype(v.dtype),
                                      torch.from_numpy(v[:0]).dtype))
            for k, v in batch.items()})

    def fill(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``batch`` copied into its buffers on the current stream (a no-op
        for a batch that is the buffers)."""
        bufs = self.like(batch)
        for k, v in batch.items():
            if v is not bufs[k]:
                bufs[k].copy_(v, non_blocking=True)
        return bufs


class InputPipeline:
    """Wraps a host ``DataLoader`` and the upload ``put`` (default:
    :func:`to_device`).  It has the loader's ``len`` and ``set_epoch``; the
    ``Trainer`` consumes :meth:`macro_batches`, which yields device
    batches."""

    mode = "sync"

    def __init__(self, loader, device, put: Optional[Callable] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.put = put or (lambda b: to_device(b, self.device))
        self.stats = TransportStats()
        self.stats.mode = self.mode

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def macro_batches(self, fuse: int = 1,
                      stage: Optional[DeviceStage] = None) -> Iterator[Step]:
        """This epoch's steps: fused groups of ``fuse`` (> 1) same-width
        batches in ``stage``'s buffers (a private stage when None), the
        rest as single steps."""
        fuse = max(1, int(fuse))
        if fuse > 1 and stage is None:
            stage = DeviceStage(self.device)
        return self._steps(fuse, stage)

    def _steps(self, k: int, stage) -> Iterator[Step]:
        raise NotImplementedError

    def _upload(self, host: Batch, fused: bool, stage) -> Dict:
        """One host batch (or ``[K, ...]`` group) on the card, timed; a
        group goes into the stage's buffers."""
        t0 = time.perf_counter()
        with _tracer().span("h2d_put", bytes=_nbytes(host)):
            if fused:
                dev = stage.like(host)
                for key, v in host.items():
                    t = torch.from_numpy(np.ascontiguousarray(v))
                    if self.device.type == "cuda":
                        t = t.pin_memory()    # a copy: the stage may reuse v
                    dev[key].copy_(t, non_blocking=True)
            else:
                dev = self.put(host)
        self.stats.record_upload(_nbytes(host), time.perf_counter() - t0)
        return dev

    def _record(self, host: Batch, n: int, ex: int) -> None:
        self.stats.record_batch(
            n, int(host["example_weight"].size), ex, seq_len=_seq_of(host),
            tokens=int(host["input_ids"].size),
            tokens_real=int(host["attention_mask"].sum()))


class SyncPipeline(InputPipeline):
    """The upload inline in the loop, instrumented."""

    mode = "sync"

    def _steps(self, k, stage):
        for host, n, fused, ex in host_macro_batches(self.loader, k):
            dev = self._upload(host, fused, stage)
            self._record(host, n, ex)
            yield dev, n, fused, ex


class DevicePrefetchPipeline(InputPipeline):
    """Double-buffered upload: batch k+1 is uploaded while step k runs.

    A worker thread uploads ahead of the loop, bounded by a 1-slot
    semaphore that the loop releases when it takes a batch: at most one
    batch is uploaded and not yet handed over.  On the card the upload
    runs on a side stream (see the module docstring for the stream
    ordering); a fused group is then copied into the stage's buffers on
    the compute stream.  Exceptions in the worker (collation or ``put``)
    reach the consumer; leaving the iterator early stops the worker in one
    bounded join.
    """

    mode = "prefetch"

    _POLL = 0.1

    def _steps(self, k, stage):
        q: queue.Queue = queue.Queue()
        slots = threading.Semaphore(1)
        stop = threading.Event()
        done = object()
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

        def upload(host):
            if side is None:
                return self.put(host), None
            with torch.cuda.stream(side):
                return self.put(host), side.record_event()

        def worker():
            try:
                for host, n, fused, ex in host_macro_batches(self.loader, k):
                    while not slots.acquire(timeout=self._POLL):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    self.stats.put_started()
                    t0 = time.perf_counter()
                    with _tracer().span("h2d_put", bytes=_nbytes(host)):
                        dev, ready = upload(host)
                    self.stats.record_upload(_nbytes(host),
                                             time.perf_counter() - t0)
                    q.put((dev, ready, n, fused, ex, _batch_record(host)))
                q.put(done)
            except BaseException as e:  # re-raised in the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                dev, ready, n, fused, ex, (_ex, n_slots, tokens) = item
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    for v in dev.values():
                        v.record_stream(compute)
                if fused:
                    dev = stage.fill(dev)
                self.stats.put_delivered()
                self.stats.record_batch(n, n_slots, ex, **tokens)
                slots.release()  # the worker may upload the next batch now
                yield dev, n, fused, ex
        finally:
            stop.set()
            t.join(timeout=2.0)  # its waits poll the stop flag


class DeviceResidentPipeline(InputPipeline):
    """Epochs without in-loop uploads: the encoded split lives on the card.

    The arrays of :func:`resident_arrays` are uploaded once; each epoch
    uploads the loader's own chunking (its sampler's, bucket widths
    included) as one ``[steps, rows]`` int64 index tensor whose filler
    slots point at the all-zero row.  A step indexes that tensor on the
    card, slices the full-width token channels to the batch's bucket and
    gathers each channel — into the stage's buffers for a fused group: the
    host loader's batch, bit for bit.
    """

    mode = "resident"

    def __init__(self, loader, device):
        super().__init__(loader, device)
        enc = loader.encoded
        if enc is None or not hasattr(enc, "arrays"):
            raise ValueError(
                "the resident pipeline needs the loader's EncodedDataset: a "
                "collator-driven loader has no frozen encoding to upload, "
                "and a multi-width packed split no single one; use "
                "pipeline='prefetch'")
        self.rows = loader.batch_size
        self._seq = enc.seq_len
        self._filler = len(enc)
        self._lengths = enc.lengths()
        w = enc.arrays.get("example_weight")
        # real examples and label slots per row (packed rows hold several)
        self._row_examples = None if w is None else (w > 0).sum(1)
        self._slots = 1 if w is None else int(w.shape[1])
        host = resident_arrays(enc)
        t0 = time.perf_counter()
        with _tracer().span("h2d_put", bytes=_nbytes(host), in_loop=False,
                            what="resident_dataset"):
            self.arrays = {k: torch.from_numpy(v).to(self.device)
                           for k, v in host.items()}
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.stats.record_upload(_nbytes(host), time.perf_counter() - t0,
                                 in_loop=False)

    def _gather(self, idx: torch.Tensor, seq: int, k: int, stage):
        """The channels at rows ``idx`` (``[k * rows]``), cut to ``seq``
        columns; ``k`` > 1 writes ``[k, rows, ...]`` into the stage."""
        cols = {}
        for key, v in self.arrays.items():
            if seq < self._seq and v.dim() == 2 and v.shape[1] == self._seq:
                v = v[:, :seq]             # the bucket's token columns
            cols[key] = v
        if k == 1:
            return {key: torch.index_select(v, 0, idx)
                    for key, v in cols.items()}
        bufs = stage.buffers({key: ((k, self.rows) + tuple(v.shape[1:]),
                                    v.dtype) for key, v in cols.items()})
        for key, v in cols.items():
            torch.index_select(v, 0, idx, out=bufs[key].view(
                (k * self.rows,) + tuple(v.shape[1:])))
        return bufs

    def _steps(self, k, stage):
        chunks = list(self.loader.chunks())
        if not chunks:
            return
        perm = np.full((len(chunks), self.rows), self._filler, np.int64)
        for i, (c, _seq) in enumerate(chunks):
            perm[i, : len(c)] = c
        t0 = time.perf_counter()
        tr0 = _tracer().now()
        perm_dev = torch.from_numpy(perm).to(self.device)
        _tracer().record("h2d_put", tr0, _tracer().now(), bytes=perm.nbytes,
                         in_loop=False, what="epoch_indices")
        self.stats.record_upload(perm.nbytes, time.perf_counter() - t0,
                                 in_loop=False)
        # runs of one width: k-groups within a run, its tail as singles
        runs: List[Tuple[int, List[int]]] = []
        for i, (_c, seq) in enumerate(chunks):
            seq = int(seq) or self._seq
            if not runs or runs[-1][0] != seq:
                runs.append((seq, []))
            runs[-1][1].append(i)
        for seq, steps in runs:
            n_fused = len(steps) // k if k > 1 else 0
            groups = [steps[g * k:(g + 1) * k] for g in range(n_fused)]                 + [[i] for i in steps[n_fused * k:]]
            for g in groups:
                n = len(g)
                idx = perm_dev[g[0]:g[-1] + 1].reshape(-1)
                batch = self._gather(idx, seq, n, stage)
                cs = [chunks[i][0] for i in g]
                ex = sum(len(c) if self._row_examples is None
                         else int(self._row_examples[c].sum()) for c in cs)
                self.stats.record_batch(
                    n, n * self.rows * self._slots, ex, seq_len=seq,
                    tokens=n * self.rows * seq,
                    tokens_real=int(sum(self._lengths[c].sum() for c in cs)))
                yield batch, n, n > 1, ex


def build_pipeline(args, loader, device=None) -> InputPipeline:
    """The mode decision, in one place.

    ``args.pipeline``: ``auto`` picks ``resident`` when eligible, else
    ``prefetch``; a named mode is forced, and forcing ``resident`` where it
    is refused raises with the reason.  Resident needs the loader's
    ``EncodedDataset`` (one rectangular encoding: not a collator, not a
    multi-width packed split), a split that fits ``--pipeline_hbm_mb``,
    and a single-process run.  ``device`` defaults to ``args.device``.
    """
    from pdnlp_tpu_torch.utils.config import resolve_device

    mode = getattr(args, "pipeline", "auto") or "auto"
    if mode not in ("auto", "resident", "prefetch", "sync"):
        raise ValueError(f"unknown pipeline mode {mode!r}; use "
                         "auto|resident|prefetch|sync")
    device = resolve_device(args.device) if device is None \
        else torch.device(device)
    enc = getattr(loader, "encoded", None)
    refusal = None
    if enc is None or not hasattr(enc, "arrays"):
        refusal = ("loader has no resident-eligible EncodedDataset "
                   "(collator-driven batches may change per epoch; a "
                   "multi-width packed split has no single rectangular "
                   "encoding to hold)")
    elif torch.distributed.is_available() \
            and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        refusal = "multi-process run: the split spans processes"
    else:
        budget = int(getattr(args, "pipeline_hbm_mb", 128)) * (1 << 20)
        nbytes = resident_nbytes(enc)
        if nbytes > budget:
            refusal = (f"encoded split is {nbytes / 2**20:.1f} MB, over the "
                       f"--pipeline_hbm_mb {budget // 2**20} MB budget")
    if mode == "resident" and refusal is not None:
        raise ValueError(f"pipeline='resident' refused: {refusal}")
    if mode == "auto":
        mode = "resident" if refusal is None else "prefetch"
    cls = {"resident": DeviceResidentPipeline,
           "prefetch": DevicePrefetchPipeline,
           "sync": SyncPipeline}[mode]
    return cls(loader, device)


def setup_pipeline(args, loader, device=None) -> InputPipeline:
    """The obs tracer configured from ``--trace`` first (the resident
    pipeline's one-time upload must land in the trace), then
    :func:`build_pipeline`."""
    from pdnlp_tpu_torch.obs.trace import configure_from_args

    configure_from_args(args)
    return build_pipeline(args, loader, device)
