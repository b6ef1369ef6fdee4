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
raises there rather than stepping aside to the plain path.  One rule is the
JAX package's own (``pdnlp_tpu/ops/attention.py:132``): attention-
probability dropout routes to the plain path on every device and for every
request, because the kernels have no dropout.  Nothing else falls back, so
the JAX package's once-per-shape fallback warnings have nothing to report
here.
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


def routed_impl(requested: str, device, dropout: bool = False) -> str:
    """The impl that runs for ``requested`` on ``device``: ``"xla"`` and
    ``"pallas"`` pass through; ``"auto"`` is the kernel on cuda and the
    plain path elsewhere; attention ``dropout`` takes the plain path
    whatever was requested (the kernels have none).  The one decision
    :func:`dot_product_attention` and ``serve.batcher.resolve_serve_pack``
    share."""
    if requested not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"attention impl must be 'auto', 'xla' or 'pallas', "
            f"got {requested!r}")
    if dropout:
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
) -> torch.Tensor:
    """``[B, S, N, D]`` attention output in q's dtype.

    ``segment_ids`` carries the packed-row block-diagonal mask (attend iff
    query and key share a nonzero segment): in-kernel on the ``pallas``
    route, a materialized ``segment_bias`` on the plain route.  ``bias`` and
    ``segment_ids`` exclude each other on every route.  ``dropout_rate`` > 0
    with a ``generator`` (training) drops attention probabilities, on the
    plain route (:func:`routed_impl`).  Differentiable on every route.
    """
    if bias is not None and segment_ids is not None:
        raise ValueError("pass bias OR segment_ids, not both — the packed "
                         "block-diagonal mask rides the IDs, and padding "
                         "is segment 0")
    use_dropout = dropout_rate > 0.0 and generator is not None
    if routed_impl(impl, q.device, use_dropout) == "pallas":
        from pdnlp_tpu_torch.ops import flash

        return flash.flash_attention(q, k, v, bias, segment_ids=segment_ids)
    if segment_ids is not None:
        from pdnlp_tpu_torch.data.packing import segment_bias

        bias = segment_bias(segment_ids).to(q.dtype)
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
