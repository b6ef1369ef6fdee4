"""Collectives — the ``all_reduce`` / ``all_gather`` twins of
``pdnlp_tpu/parallel/collectives.py``.

JAX writes them as ``lax`` collectives inside ``shard_map`` bodies; here
they are ``torch.distributed`` calls over the process group (``group``
``None`` is the default group), on the tensors' own device: NCCL on the
card, gloo on the CPU or, when asked for, on the card.

``make_global_batch`` has no twin: each rank's loader already yields its
own shard of the global batch (``train.setup.setup_data``), and nothing
assembles one global array.

Tensor and expert parallelism add the Megatron pair, which XLA inserts
from the shardings in the JAX package: :func:`copy_to_group` (identity
forward, all-reduce backward) at the entry of a block whose weights are
split over the ``model`` or ``expert`` group, and :func:`reduce_from_group`
(all-reduce forward, identity backward) after its row-split product or
partial combine.  Both act on plain local tensors, so the ctypes-bound
kernels see the local heads as they are.
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


#: DDP's bucket cap (``bucket_cap_mb`` 25): :func:`grad_reduce` sends the
#: gradients in buckets of at most this many bytes
BUCKET_BYTES = 25 * 2 ** 20


def grad_reduce(grads: Sequence[torch.Tensor], group=None,
                compress_dtype: Optional[torch.dtype] = None) -> None:
    """Mean-reduce ``grads`` across the ranks, in place, one collective per
    flat bucket of at most :data:`BUCKET_BYTES`, in reverse order (the
    order DDP's buckets become ready in; a gradient larger than the cap
    gets a bucket of its own).  Each value is reduced on its own, so the
    bucketing changes no bits.  ``compress_dtype=torch.bfloat16`` puts
    bf16 on the wire (Horovod's ``Compression.fp16`` analog): a bucket is
    cast down, reduced, divided and cast back.  No host sync and nothing
    allocated outside a captured graph's pool, so a CUDA graph can hold it
    on NCCL."""
    buckets, size = [], None
    for g in reversed([g for g in grads if g is not None]):
        nbytes = g.numel() * g.element_size()
        if size is None or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        if compress_dtype is not None:
            flat = flat.to(compress_dtype)
        dist.all_reduce(flat, group=group)
        flat = flat.to(bucket[0].dtype) / dist.get_world_size(group)
        offset = 0
        for g in bucket:
            n = g.numel()
            g.copy_(flat[offset: offset + n].view_as(g))
            offset += n


def shard_gather(out: torch.Tensor, shard: torch.Tensor, group=None) -> None:
    """``out`` (``world x shard.numel()`` values) filled with every rank's
    ``shard`` in rank order: one all-gather into a flat buffer, counted in
    :data:`STATS`.  No host sync and nothing allocated, so a CUDA graph can
    hold it on NCCL (zero's weight gather, ``parallel.sharding.
    ZeroObjective``)."""
    _counted(lambda: dist.all_gather_into_tensor(out, shard, group=group),
             out)


def shard_reduce(out: torch.Tensor, flat: torch.Tensor, group=None) -> None:
    """``out`` = this rank's block of ``flat`` summed over the ranks (one
    reduce-scatter; ``flat`` holds ``world`` blocks of ``out.numel()``
    values in rank order), counted in :data:`STATS`.  Capturable on NCCL
    as :func:`shard_gather` is (zero's gradient reduce)."""
    _counted(lambda: dist.reduce_scatter_tensor(
        out, flat, op=dist.ReduceOp.SUM, group=group), flat)


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


#: the step's counted collectives in this process — the Megatron pair's
#: all-reduces and zero's all-gathers and reduce-scatters: calls and bytes
#: (each call's input), for the step's collective record.  A replayed CUDA
#: graph runs no host code: :func:`add_stats` credits each replay with the
#: calls and bytes its capture recorded.  Their time is not kept here (on
#: NCCL a call only enqueues the collective): read the collectives' device
#: time from ``torch.profiler``'s NCCL kernels (``chip_smoke.py`` phase
#: 17b does)
STATS = {"calls": 0, "bytes": 0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0)


def stats_counts() -> dict:
    """The calls and bytes of :data:`STATS` and :data:`P2P_STATS` now."""
    return {f"{name}.{k}": table[k] for name, table in
            (("stats", STATS), ("p2p", P2P_STATS)) for k in ("calls", "bytes")}


def add_stats(counts: dict, times: int = 1) -> None:
    """Add ``times`` x ``counts`` (a :func:`stats_counts` difference: what
    a capture recorded) to the tables — the collectives of ``times``
    replays."""
    for key, n in counts.items():
        name, k = key.split(".")
        (STATS if name == "stats" else P2P_STATS)[k] += times * n


def _counted(call, t: torch.Tensor) -> None:
    """Run the collective ``call`` and count it in :data:`STATS`: one call
    and ``t``'s bytes."""
    call()
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group) -> None:
    _counted(lambda: dist.all_reduce(t, group=group), t)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(grad, ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """The partial results summed over ``group`` forward; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; in the backward its gradient is all-reduced over
    ``group`` (each rank's split block contributes a part of it)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` all-reduced (summed) over ``group``; the gradient passes
    through unchanged (every rank already holds the whole of it)."""
    return _ReduceFromGroup.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    """``psum``: the sum over ``group`` forward, and the cotangents summed
    over ``group`` backward (JAX's transpose of ``psum``) — every rank's
    input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(grad, ctx.group)
        return grad, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiable both ways (JAX's
    ``lax.psum`` in a ``shard_map`` body)."""
    return _AllReduceSum.apply(x, group)


# ---------------------------------------------------- neighbour exchange

#: how a CUDA tensor crosses between two gloo ranks: "device" hands the
#: CUDA tensor to gloo's send/recv, "host" stages it through a pinned host
#: buffer and exchanges the CPU tensor.  Fixed from the two-rank probe on
#: the H100 (``chip_smoke.py`` phase 15t, :func:`p2p_transport`), never
#: chosen by catching an error.
GLOO_CUDA_P2P = "host"

#: the point-to-point exchanges in this process: calls, bytes sent and host
#: seconds (the call to its return, the wait for the peer included), for
#: the ring's and the pipeline's exchange records; on NCCL the wait ends
#: when the transfer is enqueued on the card
P2P_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_p2p_stats() -> None:
    P2P_STATS.update(calls=0, bytes=0, seconds=0.0)


def p2p_transport(t: torch.Tensor, group=None) -> str:
    """How ``t`` travels between two ranks of ``group``: ``"device"`` (the
    tensor itself: NCCL on the card, or any backend on a CPU tensor) or
    ``"host"`` (a CUDA tensor over gloo: :data:`GLOO_CUDA_P2P`)."""
    if t.device.type == "cpu" or dist.get_backend(group) == "nccl":
        return "device"
    return GLOO_CUDA_P2P


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def exchange(send: Optional[torch.Tensor], dst: Optional[int],
             like: Optional[torch.Tensor], src: Optional[int],
             group=None) -> Optional[torch.Tensor]:
    """One point-to-point step: ``send`` to group rank ``dst`` and a tensor
    shaped and typed as ``like`` received from group rank ``src``, both in
    flight at once (either side may be None).  Returns the received tensor
    on ``like``'s device.  Under the ``"host"`` transport each side goes
    through a pinned host buffer (a copy off the card, gloo's send of the
    CPU tensor, a copy back on).  On NCCL the two sides go as one grouped
    call (``dist.batch_isend_irecv``, NCCL's group of a send and a
    receive): posted one by one, a cyclic shift over three or more ranks
    would have every rank wait on its successor to join the pair's first
    transfer.  ``P2P_STATS`` counts the call, the bytes sent and the host
    seconds, waiting for the peer included."""
    import time

    t0 = time.perf_counter()
    ops, staged, buf = [], None, None
    ref = send if send is not None else like
    host = p2p_transport(ref, group) == "host"
    if send is not None:
        staged = send.detach().contiguous()
        if host:
            staged = torch.empty(staged.shape, dtype=staged.dtype,
                                 pin_memory=True).copy_(staged)
        ops.append((dist.isend, staged, _global(group, dst)))
        P2P_STATS["bytes"] += staged.numel() * staged.element_size()
    if like is not None:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device,
                          pin_memory=host)
        ops.append((dist.irecv, buf, _global(group, src)))
    if ops and ref.device.type == "cuda" and dist.get_backend(group) == "nccl":
        works = dist.batch_isend_irecv([dist.P2POp(op, t, peer, group=group)
                                        for op, t, peer in ops])
    else:
        works = [op(t, peer, group=group) for op, t, peer in ops]
    for w in works:
        w.wait()
    if buf is not None and host:
        buf = buf.to(like.device)
    P2P_STATS["calls"] += 1
    P2P_STATS["seconds"] += time.perf_counter() - t0
    return buf


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = world_size(group)
    if shift % n == 0:
        return x.clone()
    me = dist.get_rank(group)
    return exchange(x, (me + shift) % n, x, (me - shift) % n, group)


class _PPermute(torch.autograd.Function):
    """JAX's ``lax.ppermute`` by a cyclic ``shift``: rank ``r`` sends to
    ``r + shift`` and receives from ``r - shift``; backward sends the
    cotangent by ``-shift``, the transpose of the permutation."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad.contiguous(), ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` of rank ``r - shift`` of ``group`` (cyclic), on every rank;
    differentiable (the cotangent travels back by ``-shift``).  Every rank
    of the group calls it with the same shapes, in the same order, so the
    hops of a backward pair up across the ranks as the forward's do."""
    if x.requires_grad:
        return _PPermute.apply(x, group, shift)
    return _permute(x, group, shift)
