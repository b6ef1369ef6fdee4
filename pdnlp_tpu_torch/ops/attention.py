"""Multi-head scaled-dot-product attention and its routing policy
(``pdnlp_tpu/ops/attention.py``).

``impl`` keeps the JAX package's values, with the port's meanings:

- ``"xla"`` — the plain PyTorch path: einsum scores, additive mask, fp32
  softmax (packed rows build the ``[B, 1, S, S]`` segment bias here);
- ``"pallas"`` — the hand-written CUDA flash kernel (``ops.flash``), which
  computes the packed mask in-kernel from the segment IDs;
- ``"auto"`` — the kernel on CUDA, the plain path on the CPU.

The TPU package's measured ``ROUTING_TABLE`` is not carried over: its
crossovers were taken on a TPU.  ``auto`` sends every attention on the card
to the kernels (forward and, in training, backward), at every sequence
width; a shape the kernel does not take (a head width other than 64)
raises there rather than stepping aside to the plain path.  Three rules
are the JAX package's own, and each routes to the plain path on every
device and for every request, by name (:func:`routed_impl`):

- attention-probability dropout (``pdnlp_tpu/ops/attention.py:132``): the
  kernels have no dropout;
- causal attention (``:134-146``): the kernels have no causal term, so the
  generative decoder's bucketed prefill runs the plain path;
- a query that does not tile the kernel's query blocks (``:147-150``).  K1
  walks 64-row query tiles over keys of the query's own extent under one
  per-key mask (it masks a ragged last tile itself, so the classifier's
  32-token bucket still runs it).  A query over the KV cache has no such
  grid: the ``[rows, 1]`` decode step attends a longer key extent, and a
  paged chunk carries a mask per query row.

Nothing else falls back, so the JAX package's once-per-shape fallback
warnings have nothing to report here.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # additive mask bias; well inside bf16/f32 range


def mask_bias(attention_mask: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, S]`` {0,1} mask -> ``[B, 1, 1, S]`` additive bias (0 keep /
    -1e9 drop)."""
    return ((1.0 - attention_mask.to(torch.float32)) * NEG_INF).to(dtype)[
        :, None, None, :]


def causal_bias(seq_len: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """``[1, 1, S, S]`` additive causal bias: row i attends keys j <= i
    (0 keep / -1e9 drop).  The one quadratic mask site: the decoder's
    bucketed prefill composes it with the key-padding bias here, and the
    per-step decode never needs it (a ``[rows, 1]`` query masks with the
    linear visibility bias, ``mask_bias`` of "position <= current")."""
    i = torch.arange(seq_len, device=device)
    keep = i[:, None] >= i[None, :]
    return torch.where(keep, 0.0, NEG_INF).to(dtype)[None, None]


def routed_impl(requested: str, device, dropout: bool = False, *,
                causal: bool = False, cached: bool = False) -> str:
    """The impl that runs for ``requested`` on ``device``: ``"xla"`` and
    ``"pallas"`` pass through; ``"auto"`` is the kernel on cuda and the
    plain path elsewhere.  Whatever was requested, three cases take the
    plain path (the module's rules): attention ``dropout``, ``causal``
    attention, and a ``cached`` query (one over the KV cache, which does
    not tile the kernel's query blocks).  The one decision
    :func:`dot_product_attention`, ``serve.batcher.resolve_serve_pack``
    and the engines' span attrs share."""
    if requested not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"attention impl must be 'auto', 'xla' or 'pallas', "
            f"got {requested!r}")
    if dropout or causal or cached:
        return "xla"
    if requested == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    return requested


def dot_product_attention(
    q: torch.Tensor,   # [B, S, N, D]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,   # broadcastable to [B, N, Sq, Sk]
    impl: str = "auto",
    segment_ids: Optional[torch.Tensor] = None,   # [B, S] int, 0 = padding
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    causal: bool = False,
) -> torch.Tensor:
    """``[B, S, N, D]`` attention output in q's dtype.

    ``segment_ids`` carries the packed-row block-diagonal mask (attend iff
    query and key share a nonzero segment): in-kernel on the ``pallas``
    route, a materialized ``segment_bias`` on the plain route.  ``bias`` and
    ``segment_ids`` exclude each other on every route.  ``dropout_rate`` > 0
    with a ``generator`` (training) drops attention probabilities, on the
    plain route (:func:`routed_impl`).  Differentiable on every route.

    ``causal=True`` also masks row i from keys j > i (:func:`causal_bias`),
    composed with the key ``bias`` or the ``segment_ids``; it needs
    ``Sq == Sk`` and takes the plain route.  A query over the KV cache — a
    longer key extent than its own (the decode step) or a ``bias`` with a
    row per query (a paged chunk) — carries its own visibility bias and
    takes the plain route too.
    """
    if bias is not None and segment_ids is not None:
        raise ValueError("pass bias OR segment_ids, not both — the packed "
                         "block-diagonal mask rides the IDs, and padding "
                         "is segment 0")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            "causal=True needs Sq == Sk (a square mask); a decode-step "
            "query over a longer KV cache masks with its own linear "
            "visibility bias (mask_bias of 'position <= current')")
    use_dropout = dropout_rate > 0.0 and generator is not None
    cached = k.shape[1] != q.shape[1] or (bias is not None
                                          and bias.shape[-2] != 1)
    if routed_impl(impl, q.device, use_dropout, causal=causal,
                   cached=cached) == "pallas":
        from pdnlp_tpu_torch.ops import flash

        return flash.flash_attention(q, k, v, bias, segment_ids=segment_ids)
    if segment_ids is not None:
        from pdnlp_tpu_torch.data.packing import segment_bias

        bias = segment_bias(segment_ids).to(q.dtype)
    if causal:
        cb = causal_bias(q.shape[1], device=q.device)
        bias = cb if bias is None else bias.to(torch.float32) + cb
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    if use_dropout:
        keep = 1.0 - dropout_rate
        mask = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < keep
        probs = torch.where(mask, probs / keep, 0.0).to(probs.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)
