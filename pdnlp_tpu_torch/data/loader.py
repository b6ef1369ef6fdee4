"""Batched data loader with a background collation thread
(``pdnlp_tpu/data/loader.py``).

One worker thread assembles batches into a bounded queue while the card
runs the previous step; every put polls a stop flag, so a consumer that
breaks out early tears the worker down in one bounded join.  Every batch
has the full static shape; a short final batch carries zero-weight filler
rows (``data.collate``).
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

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def _chunks(self) -> Iterator[List[int]]:
        idx = list(self.sampler)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _make(self, chunk: List[int]) -> Batch:
        if self.encoded is not None:
            return self.encoded.take(chunk, pad_to=self.batch_size)
        return self.collator([self.data[j] for j in chunk],
                             pad_to=self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            for chunk in self._chunks():
                yield self._make(chunk)
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
                for chunk in self._chunks():
                    if not put_or_stop(self._make(chunk)):
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
