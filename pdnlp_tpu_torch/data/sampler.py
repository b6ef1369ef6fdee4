"""Deterministic sharding of the dataset — the ``DistributedSampler``
analog — and length-grouped batching (``pdnlp_tpu/data/sampler.py``).

Each shard takes a strided slice of one epoch-seeded permutation, padded by
wrapping so every shard sees the same number of steps.  Every epoch order
is a pure function of ``(seed, epoch)``, drawn from
``np.random.RandomState(seed + epoch)`` as the JAX package draws it, so
both packages feed the same indices in the same order.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


class DistributedShardSampler:
    def __init__(
        self,
        num_examples: int,
        num_shards: int = 1,
        shard_id: int = 0,
        shuffle: bool = True,
        seed: int = 123,
        drop_last: bool = False,
    ):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        self.num_examples = num_examples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.shard_len = num_examples // num_shards
        else:
            self.shard_len = -(-num_examples // num_shards)  # ceil

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle differently each epoch (``DistributedSampler.set_epoch``)."""
        self.epoch = epoch

    def global_order(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            return rng.permutation(self.num_examples)
        return np.arange(self.num_examples)

    def shard_indices(self) -> np.ndarray:
        """This shard's indices: strided slice of the (padded) global order."""
        order = self.global_order()
        total = self.shard_len * self.num_shards
        if total > len(order):  # pad by wrapping, like DistributedSampler
            order = np.concatenate([order, order[: total - len(order)]])
        else:
            order = order[:total]
        return order[self.shard_id:: self.num_shards]

    def __iter__(self) -> Iterator[int]:
        return iter(self.shard_indices().tolist())

    def __len__(self) -> int:
        return self.shard_len


# --------------------------------------------------------------------------
# length-aware batching (--length_mode)
# --------------------------------------------------------------------------

def parse_buckets(spec: str, max_seq_len: int) -> Tuple[int, ...]:
    """``"32,64,128"`` -> sorted bucket widths, clipped to ``max_seq_len``.

    Widths over ``max_seq_len`` are dropped (the encoding truncates there,
    so a wider bucket could never fill) and ``max_seq_len`` itself is
    always the last bucket, so every example has a covering bucket."""
    try:
        widths = {int(w) for w in str(spec).split(",") if str(w).strip()}
    except ValueError:
        raise ValueError(f"--length_buckets must be comma-separated ints, "
                         f"got {spec!r}") from None
    if any(w < 2 for w in widths):
        raise ValueError(f"bucket widths must be >= 2 ([CLS]+[SEP]), "
                         f"got {sorted(widths)}")
    return tuple(sorted(w for w in widths if w < max_seq_len)) + (max_seq_len,)


def validate_length_buckets(widths: Sequence[int], *, max_position: int,
                            model: str, mode: str = "bucket",
                            max_seq_len: int = None) -> None:
    """Check ``--length_buckets`` against the position table at setup.

    Position embeddings are a gather into the model's ``[max_position, H]``
    table.  On CUDA an index past the table is a device-side assert that
    poisons the CUDA context for the rest of the process, far from the
    flag that caused it (JAX clamps the same gather and trains on garbage
    embeddings).  So the widths are refused here, before any gather runs.

    - ``mode="bucket"`` (unpacked rows, positions 0..width-1): every
      bucket width must fit the table;
    - ``mode="pack"`` (packed rows, positions restart per segment): the
      bound is the longest segment, the encode width ``max_seq_len``; a
      packed row may be wider than the table.
    """
    if mode == "bucket":
        bad = sorted(int(w) for w in widths if int(w) > int(max_position))
        if bad:
            raise ValueError(
                f"--length_buckets includes {bad} but {model}'s position "
                f"table has only {max_position} positions: an unpacked "
                f"{bad[0]}-wide batch would index position embeddings past "
                "the table (a device-side assert on CUDA).  Drop the "
                "bucket or use a model with more positions")
    elif max_seq_len is not None and int(max_seq_len) > int(max_position):
        raise ValueError(
            f"--length_mode pack with --max_seq_len {max_seq_len} exceeds "
            f"{model}'s {max_position}-position table: packed positions "
            "restart per segment, so the bound is the longest segment (the "
            "encode width), and a longer one would index position "
            "embeddings past the table.  Lower --max_seq_len")


def resolve_length_mode(args) -> str:
    """The ``--length_mode`` decision, in one place: ``auto`` is ``full``.
    bucket and pack keep each example's own math but change which examples
    share a step, so a run opts in."""
    mode = getattr(args, "length_mode", "auto") or "auto"
    if mode not in ("auto", "full", "bucket", "pack"):
        raise ValueError(f"unknown length_mode {mode!r}; use "
                         "auto|full|bucket|pack")
    return "full" if mode == "auto" else mode


class LengthGroupedSampler:
    """Seeded length-grouped batching: bucket-homogeneous batches that
    shard deterministically across processes.

    Every process computes the same global batch sequence from the seed:
    per epoch, examples are permuted within their length bucket, chopped
    into global batches of ``batch_size * num_shards``, and the epoch
    visits the buckets as contiguous blocks in a seeded order; each
    process then takes its strided slice of each global batch.  So every
    process feeds the same bucket at every step, and the batches per
    bucket (the epoch's structure) are the same every epoch: bucket
    membership is a function of the data, only the order reshuffles.

    Grouping changes which examples share a batch, never an example's own
    tokens, mask or weight.  The last batch of each bucket may be short;
    the loader pads it with zero-weight filler rows.
    """

    def __init__(
        self,
        lengths: Sequence[int],
        batch_size: int,
        buckets: Sequence[int] = (32, 64, 128),
        num_shards: int = 1,
        shard_id: int = 0,
        shuffle: bool = True,
        seed: int = 123,
        drop_last: bool = False,
    ):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        self.lengths = np.asarray(lengths, np.int64)
        self.num_examples = len(self.lengths)
        self.batch_size = int(batch_size)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # the smallest covering width; over-long examples land in the last
        # bucket (the encoding truncated them there)
        edges = np.asarray(self.buckets, np.int64)
        self._member = edges[np.minimum(
            np.searchsorted(edges, self.lengths), len(edges) - 1)]
        G = self.batch_size * self.num_shards
        self.batches_per_epoch = 0
        for b in self.buckets:
            n = int((self._member == b).sum())
            self.batches_per_epoch += (n // G if drop_last
                                       else -(-n // G)) if n else 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def global_batches(self) -> List[Tuple[np.ndarray, int]]:
        """This epoch's ``(global_indices, bucket)`` sequence, the same on
        every process: buckets as contiguous blocks (a bucket's short tail
        batch last in its block) in a seeded block order."""
        rng = np.random.RandomState(self.seed + self.epoch)
        G = self.batch_size * self.num_shards
        blocks: List[List[Tuple[np.ndarray, int]]] = []
        for b in self.buckets:  # ascending: a fixed order of rng draws
            idx = np.flatnonzero(self._member == b)
            if not len(idx):
                continue
            if self.shuffle:
                idx = idx[rng.permutation(len(idx))]
            chunks = [(idx[i: i + G], int(b)) for i in range(0, len(idx), G)]
            if self.drop_last and len(chunks) and len(chunks[-1][0]) < G:
                chunks.pop()
            if chunks:
                blocks.append(chunks)
        if self.shuffle:
            blocks = [blocks[i] for i in rng.permutation(len(blocks))]
        return [c for block in blocks for c in block]

    def chunks(self) -> Iterator[Tuple[List[int], int]]:
        """``(local_indices, bucket)`` per batch: this shard's strided slice
        of each global batch, so every process sees every step."""
        for gidx, bucket in self.global_batches():
            yield gidx[self.shard_id:: self.num_shards].tolist(), bucket

    def __iter__(self) -> Iterator[int]:
        for chunk, _bucket in self.chunks():
            yield from chunk

    def __len__(self) -> int:
        """Examples this shard feeds per epoch, from the epoch-invariant
        bucket membership: a full global batch gives ``batch_size`` rows
        to each shard, a tail of t rows ``|{i < t : i = shard_id mod
        num_shards}|``.  (The loader counts steps with
        ``batches_per_epoch``.)"""
        G = self.batch_size * self.num_shards
        total = 0
        for b in self.buckets:
            n = int((self._member == b).sum())
            full, tail = divmod(n, G)
            total += full * self.batch_size
            if not self.drop_last and tail > self.shard_id:
                total += -(-(tail - self.shard_id) // self.num_shards)
        return total


class BatchBlockSampler:
    """Each global batch of ``loader`` cut to shard ``shard_id``'s
    contiguous block of ``batch_size / num_shards`` rows — how a
    ``P("data")`` placement splits one batch over devices, and
    ``nn.DataParallel``'s scatter.  Every shard reads the same global
    order (the loader's own sampler, any length mode), so the steps per
    epoch are the global loader's; the rows of a short last batch fall to
    the first blocks, and a block past them is all filler (weight 0)."""

    def __init__(self, loader, num_shards: int, shard_id: int):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        if loader.batch_size % num_shards:
            raise ValueError(f"batch {loader.batch_size} does not split into "
                             f"{num_shards} blocks")
        self.loader = loader
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.rows = loader.batch_size // num_shards
        self.batches_per_epoch = len(loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def chunks(self) -> Iterator[Tuple[List[int], int]]:
        lo = self.shard_id * self.rows
        for idx, seq_len in self.loader.chunks():
            yield list(idx[lo: lo + self.rows]), seq_len

