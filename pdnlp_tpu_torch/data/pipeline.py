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

Every mode feeds the ``Trainer`` through ``macro_batches(fuse)``, which
yields ``(device_batch, n_steps, fused, examples)``; ``examples`` is
counted on the host, so the loop never reads a device value to count.
``fuse`` is 1 here: K steps in one dispatch is CUDA graph capture
(ROADMAP A4).  Each pipeline records
:class:`~pdnlp_tpu_torch.utils.metrics.TransportStats`.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

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

    def macro_batches(self, fuse: int = 1) -> Iterator[Step]:
        """This epoch's steps as ``(device_batch, 1, False, examples)``."""
        if int(fuse) != 1:
            raise ValueError(f"fuse_steps {fuse}: K steps in one dispatch "
                             "needs CUDA graph capture (ROADMAP A4)")
        return self._steps()

    def _steps(self) -> Iterator[Step]:
        raise NotImplementedError


class SyncPipeline(InputPipeline):
    """The upload inline in the loop, instrumented."""

    mode = "sync"

    def _steps(self):
        for host in self.loader:
            t0 = time.perf_counter()
            dev = self.put(host)
            self.stats.record_upload(_nbytes(host), time.perf_counter() - t0)
            ex, slots, tokens = _batch_record(host)
            self.stats.record_batch(1, slots, ex, **tokens)
            yield dev, 1, False, ex


class DevicePrefetchPipeline(InputPipeline):
    """Double-buffered upload: batch k+1 is uploaded while step k runs.

    A worker thread uploads ahead of the loop, bounded by a 1-slot
    semaphore that the loop releases when it takes a batch: at most one
    batch is uploaded and not yet handed over.  On the card the upload
    runs on a side stream (see the module docstring for the stream
    ordering).  Exceptions in the worker (collation or ``put``) reach the
    consumer; leaving the iterator early stops the worker in one bounded
    join.
    """

    mode = "prefetch"

    _POLL = 0.1

    def _steps(self):
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
                for host in self.loader:
                    while not slots.acquire(timeout=self._POLL):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        return
                    self.stats.put_started()
                    t0 = time.perf_counter()
                    dev, ready = upload(host)
                    self.stats.record_upload(_nbytes(host),
                                             time.perf_counter() - t0)
                    q.put((dev, ready, _batch_record(host)))  # unbounded
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
                dev, ready, (ex, n_slots, tokens) = item
                if ready is not None:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready)
                    for v in dev.values():
                        v.record_stream(compute)
                self.stats.put_delivered()
                self.stats.record_batch(1, n_slots, ex, **tokens)
                slots.release()  # the worker may upload the next batch now
                yield dev, 1, False, ex
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
    gathers each channel: the host loader's batch, bit for bit.
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
        self.arrays = {k: torch.from_numpy(v).to(self.device)
                       for k, v in host.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.record_upload(_nbytes(host), time.perf_counter() - t0,
                                 in_loop=False)

    def _steps(self):
        chunks = list(self.loader.chunks())
        if not chunks:
            return
        perm = np.full((len(chunks), self.rows), self._filler, np.int64)
        for i, (c, _seq) in enumerate(chunks):
            perm[i, : len(c)] = c
        t0 = time.perf_counter()
        perm_dev = torch.from_numpy(perm).to(self.device)
        self.stats.record_upload(perm.nbytes, time.perf_counter() - t0,
                                 in_loop=False)
        for i, (c, seq) in enumerate(chunks):
            seq = int(seq) or self._seq
            idx = perm_dev[i]
            batch = {}
            for k, v in self.arrays.items():
                if seq < self._seq and v.dim() == 2 \
                        and v.shape[1] == self._seq:
                    v = v[:, :seq]         # the bucket's token columns
                batch[k] = torch.index_select(v, 0, idx)
            ex = (len(c) if self._row_examples is None
                  else int(self._row_examples[c].sum()))
            self.stats.record_batch(
                1, self.rows * self._slots, ex, seq_len=seq,
                tokens=self.rows * seq,
                tokens_real=int(self._lengths[c].sum()))
            yield batch, 1, False, ex


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
