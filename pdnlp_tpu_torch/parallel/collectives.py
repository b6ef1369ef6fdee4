"""Collectives — the ``all_reduce`` / ``all_gather`` twins of
``pdnlp_tpu/parallel/collectives.py``.

JAX writes them as ``lax`` collectives inside ``shard_map`` bodies; here
they are ``torch.distributed`` calls over the process group (``group``
``None`` is the default group), on the tensors' own device: NCCL on the
card, gloo on the CPU or, when asked for, on the card.

``make_global_batch`` has no twin: each rank's loader already yields its
own shard of the global batch (``train.setup.setup_data``), and nothing
assembles one global array.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world_size(group=None) -> int:
    """Ranks in ``group``; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def loss_reduce(loss: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the ranks (``all_reduce(SUM) / world``)."""
    out = loss.detach().clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


def weighted_shard_scale(local_weight: torch.Tensor, group=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lw / gw, gw)`` with ``gw = max(sum of the ranks' lw, 1)``: a
    rank's weighted mean times ``lw / gw``, summed over the ranks, is the
    exact global weighted mean, even when filler rows make the shards
    uneven; the guard keeps an all-filler global batch at 0, not 0/0."""
    gw = local_weight.detach().to(torch.float32).clone()
    dist.all_reduce(gw, group=group)
    gw = gw.clamp_min(1.0)
    return local_weight / gw, gw


def grad_reduce(grads: Sequence[torch.Tensor], group=None,
                compress_dtype: Optional[torch.dtype] = None) -> None:
    """Mean-reduce ``grads`` across the ranks, in place, in one collective
    over one flat buffer.  ``compress_dtype=torch.bfloat16`` puts bf16 on
    the wire (Horovod's ``Compression.fp16`` analog): the buffer is cast
    down, reduced, divided and cast back."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if compress_dtype is not None:
        flat = flat.to(compress_dtype)
    dist.all_reduce(flat, group=group)
    flat = flat.to(grads[0].dtype) / dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset: offset + n].view_as(g))
        offset += n


def output_reduce(*arrays: torch.Tensor, group=None) -> List[torch.Tensor]:
    """All-gather each per-rank array along its first axis into the global
    one, rank 0's rows first (``dist.all_gather``, tiled).  Every rank
    passes arrays of the same shapes."""
    world = dist.get_world_size(group)
    out = []
    for a in arrays:
        parts = [torch.empty_like(a) for _ in range(world)]
        dist.all_gather(parts, a.contiguous(), group=group)
        out.append(torch.cat(parts))
    return out


def barrier(group=None) -> None:
    """Host-level sync across the ranks (``dist.barrier()``); a no-op
    without a process group."""
    if dist.is_initialized():
        dist.barrier(group=group)
