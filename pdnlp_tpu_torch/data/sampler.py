"""Deterministic sharding of the dataset — the ``DistributedSampler``
analog (``pdnlp_tpu/data/sampler.py``).

Each shard takes a strided slice of one epoch-seeded permutation, padded by
wrapping so every shard sees the same number of steps.  Every epoch order
is a pure function of ``(seed, epoch)``.  The length-grouped sampler waits
for length-aware training (ROADMAP A8).
"""
from __future__ import annotations

from typing import Iterator

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
