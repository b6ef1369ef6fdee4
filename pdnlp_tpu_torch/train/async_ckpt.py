"""Asynchronous resume snapshots: the step loop pays the device→host copy
only (``pdnlp_tpu/train/async_ckpt.py``).

The caller (the trainer's ``ckpt_save`` span) copies the state to host
memory — the one part that must see a consistent state — and hands the
copy to :meth:`AsyncCheckpointer.submit`, which returns at once.  One
writer thread encodes and crash-atomically publishes
(``checkpoint.publish``: tmp + rename + checksum manifest):

- **one write in flight**: the writer publishes one file at a time; while
  it writes, at most one newer snapshot per path waits, and a later submit
  for the same path replaces the waiting one (latest wins);
- **errors surface**: a failed write raises on the next :meth:`submit` or
  :meth:`wait`, naming every failed path;
- **rank 0 writes**: on any other rank :meth:`submit` is a no-op.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class AsyncCheckpointer:
    def __init__(self, process_index: Optional[int] = None):
        if process_index is None:
            import torch.distributed as dist

            process_index = (dist.get_rank() if dist.is_available()
                             and dist.is_initialized() else 0)
        self.process_index = int(process_index)
        self._cond = threading.Condition()
        #: path -> (kind, payload, meta), FIFO across paths, latest-wins per
        #: path; kind "state" = an object to encode and publish, "json" = a
        #: small sidecar for write_json_atomic
        self._pending: "collections.OrderedDict[str, Tuple[str, Any, Optional[Dict]]]" \
            = collections.OrderedDict()
        self._in_flight: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._errors: List[Tuple[str, BaseException]] = []
        self.submitted = 0
        self.published = 0
        self.superseded = 0

    def submit(self, path: str, host_obj: Any,
               meta: Optional[Dict] = None) -> None:
        """Queue one publish of ``host_obj`` (host tensors only) to
        ``path``; returns at once.  Raises the writer's pending error
        first."""
        self._enqueue(path, "state", host_obj, meta)

    def submit_json(self, path: str, obj: Any) -> None:
        """Queue a small JSON sidecar write on the same writer."""
        self._enqueue(path, "json", obj, None)

    def _enqueue(self, path: str, kind: str, payload: Any,
                 meta: Optional[Dict]) -> None:
        self._raise_pending_error()
        if self.process_index != 0:
            return
        with self._cond:
            if path in self._pending:
                self.superseded += 1
                del self._pending[path]
            self._pending[path] = (kind, payload, meta)
            self.submitted += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="async-ckpt-writer", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def _run(self) -> None:
        from pdnlp_tpu_torch.train import checkpoint as ckpt

        while True:
            with self._cond:
                while not self._pending:
                    self._cond.wait()
                path, (kind, payload, meta) = self._pending.popitem(last=False)
                self._in_flight = path
            try:
                if kind == "json":
                    ckpt.write_json_atomic(path, payload)
                else:
                    ckpt.publish(path, ckpt.encode(path, payload), meta=meta)
                with self._cond:
                    self.published += 1
            except BaseException as e:       # surfaced at next submit/wait
                with self._cond:
                    self._errors.append((path, e))
            finally:
                with self._cond:
                    self._in_flight = None
                    self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted write is published (False after
        ``timeout`` seconds; nothing is cancelled); then re-raise the first
        writer error."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending or self._in_flight is not None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
        self._raise_pending_error()
        return True

    def _raise_pending_error(self) -> None:
        with self._cond:
            if not self._errors:
                return
            errors, self._errors = self._errors, []
        raise RuntimeError(
            "async checkpoint publish failed for "
            + ", ".join(f"{p!r} ({type(e).__name__}: {e})"
                        for p, e in errors)) from errors[0][1]

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"submitted": self.submitted, "published": self.published,
                    "superseded": self.superseded,
                    "errors": len(self._errors)}
