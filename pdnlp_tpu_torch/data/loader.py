"""Batched data loader with a background collation thread
(``pdnlp_tpu/data/loader.py``).

One worker thread assembles batches into a bounded queue while the card
runs the previous step; every put polls a stop flag, so a consumer that
breaks out early tears the worker down in one bounded join.  Every batch
has the full row count; a short final batch carries zero-weight filler
rows (``data.collate``).  A batching sampler (``LengthGroupedSampler``)
supplies each batch's indices and token width.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

from pdnlp_tpu_torch.data.collate import Batch, Collator, EncodedDataset
from pdnlp_tpu_torch.data.sampler import DistributedShardSampler


class DataLoader:
    def __init__(
        self,
        data: Sequence[Tuple[str, int]],
        collator: Collator,
        batch_size: int,
        sampler: Optional[DistributedShardSampler] = None,
        drop_last: bool = False,
        prefetch: int = 2,
        encoded: Optional[EncodedDataset] = None,
    ):
        """``encoded`` short-circuits collation: batches become numpy
        fancy-indexes into the once-encoded split."""
        self.data = data
        self.collator = collator
        self.batch_size = batch_size
        self.sampler = sampler or DistributedShardSampler(len(data),
                                                          shuffle=False)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.encoded = encoded
        if (hasattr(self.sampler, "chunks") and self.drop_last
                and not getattr(self.sampler, "drop_last", False)):
            # the sampler chunks global batches: a shard-local length test
            # here would drop different steps on different processes (a
            # 15-row global tail is 8 rows on shard 0 and 7 on shard 1)
            raise ValueError(
                "drop_last with a batching sampler must be set on the "
                "sampler (it owns the global chunking), not the loader")

    def __len__(self) -> int:
        n_batches = getattr(self.sampler, "batches_per_epoch", None)
        if n_batches is not None:
            return n_batches
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def chunks(self) -> Iterator[Tuple[List[int], int]]:
        """``(indices, seq_len)`` per batch, this epoch (JAX's ``_chunks``);
        ``seq_len`` 0 is the full ``max_seq_len``.  A sampler with
        ``chunks()`` supplies both.  The host batches and the resident
        pipeline's on-card gathers both follow it."""
        if hasattr(self.sampler, "chunks"):
            yield from self.sampler.chunks()
            return
        idx = list(self.sampler)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk, 0

    def _make(self, chunk: List[int], seq_len: int = 0) -> Batch:
        if self.encoded is not None:
            return self.encoded.take(chunk, pad_to=self.batch_size,
                                     seq_len=seq_len)
        return self.collator([self.data[j] for j in chunk],
                             pad_to=self.batch_size, seq_len=seq_len)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            for chunk, seq_len in self.chunks():
                yield self._make(chunk, seq_len)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """A bounded put that notices the consumer leaving: every worker
            put polls the stop flag, so an early ``break`` never strands the
            thread on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for chunk, seq_len in self.chunks():
                    if not put_or_stop(self._make(chunk, seq_len)):
                        return
                put_or_stop(done)
            except BaseException as e:  # handed to the consumer, re-raised there
                put_or_stop(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=2.0)
