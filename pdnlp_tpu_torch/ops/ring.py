"""Ring attention — sequence-parallel attention over the ranks of a ``seq``
group, the twin of ``pdnlp_tpu/ops/ring.py``.

Each rank holds a ``[B, S_local]`` slice of the sequence.  Attention needs
every query slice to see every key slice, so the ring takes ``n`` hops over
the ``n`` ranks: each hop computes the blockwise attention of the local
queries against the K/V block the rank holds (:func:`block_attn`: the fp32
numerator, row max ``m`` and row sum ``l``), folds it into an online
softmax, and passes the block on to the next rank (``parallel.collectives.
ppermute``, whose backward sends the cotangent back the other way).  The
first hop uses the rank's own block, so there are ``n - 1`` exchanges.

The JAX package's ``_block_attn`` is XLA einsums, not a Pallas kernel, so
this is plain PyTorch on every device; running each hop through the flash
kernel K1 (which returns ``m`` and ``l`` already) is speed work.  The mask
value is -1e9, as in ``ops.attention``.

The key mask is a ``[B, S_local]`` additive bias that rides the ring with
its block; packed rows pass ``segment_ids`` instead, and each hop builds
the shard-local block-diagonal mask of its (local, visiting) ID pair, so no
``[B, 1, S, S]`` bias exists on any rank.  Attention-probability dropout
draws one mask per (shard, hop) from the rank's ``torch.Generator``,
applied to the numerator while ``l`` keeps the undropped sum, so ``acc /
l`` is ``dropout(softmax(s)) @ v`` (the same distribution as the plain
path, other draws).
"""
from __future__ import annotations

from typing import Optional

import torch

from pdnlp_tpu_torch.ops.attention import NEG_INF


def block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               q_seg: Optional[torch.Tensor] = None,
               k_seg: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               keep: float = 1.0):
    """One blockwise partial attention: ``(numerator [B, Sq, N, D], m [B,
    N, Sq, 1], l [B, N, Sq, 1])`` in fp32 — the merge state of the online
    softmax.  ``bias`` is the visiting block's ``[B, Sk]`` key bias;
    ``q_seg``/``k_seg`` (``[B, Sq]``/``[B, Sk]``, 0 = padding) the packed
    layout's segment IDs; ``generator`` drops probabilities (kept with
    probability ``keep``) in the numerator only."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if bias is not None:
        s = s + bias.to(torch.float32)[:, None, None, :]
    if q_seg is not None:
        same = (q_seg[:, :, None] == k_seg[:, None, :]) & \
            (q_seg[:, :, None] > 0)
        s = s + torch.where(same, 0.0, NEG_INF)[:, None, :, :]
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if generator is not None:
        mask = torch.rand(p.shape, generator=generator,
                          device=p.device) < keep
        p = torch.where(mask, p / keep, 0.0)
    num = torch.einsum("bnqk,bknd->bqnd", p, v.to(torch.float32))
    return num, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias_local: Optional[torch.Tensor], group,
                   dropout_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Attention of this rank's queries ``[B, S_local, N, D]`` over the
    whole sequence, whose K/V slices the ranks of ``group`` hold in rank
    order: this rank's rows of single-device attention over the gathered
    sequence, in ``q``'s dtype.

    ``bias_local`` is the ``[B, S_local]`` additive key bias of this
    rank's slice; ``segment_ids`` (``[B, S_local]``, 0 = padding) selects
    the packed layout instead (the two exclude each other).  Dropout needs
    a rate and a ``generator``."""
    from pdnlp_tpu_torch.parallel.collectives import ppermute, world_size

    n = world_size(group)
    if segment_ids is not None:
        if bias_local is not None:
            raise ValueError("pass bias_local OR segment_ids, not both — "
                             "packed padding is segment 0 and needs no "
                             "separate mask")
        q_seg = segment_ids.to(torch.int32)
        extra = q_seg                        # the key-side IDs ride the ring
    else:
        q_seg = None
        extra = (bias_local.to(torch.float32) if bias_local is not None
                 else q.new_zeros(q.shape[:2], dtype=torch.float32))
    dropping = dropout_rate > 0.0 and generator is not None
    gen = generator if dropping else None
    keep = 1.0 - dropout_rate

    def block(k_blk, v_blk, x_blk):
        if q_seg is not None:
            return block_attn(q, k_blk, v_blk, q_seg=q_seg, k_seg=x_blk,
                              generator=gen, keep=keep)
        return block_attn(q, k_blk, v_blk, x_blk, generator=gen, keep=keep)

    # hop 0: this rank's own block, no exchange
    acc, m, l = block(k, v, extra)
    kv = torch.stack([k, v])                 # one exchange per hop for both
    for _ in range(1, n):
        kv = ppermute(kv, group, 1)
        extra = ppermute(extra, group, 1)
        num, m_blk, l_blk = block(kv[0], kv[1], extra)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)         # rescale the accumulator
        beta = torch.exp(m_blk - m_new)      # rescale the new block
        l = l * alpha + l_blk * beta
        acc = acc * alpha.transpose(1, 2) + num * beta.transpose(1, 2)
        m = m_new
    out = acc / l.clamp_min(1e-30).transpose(1, 2)
    return out.to(q.dtype)
