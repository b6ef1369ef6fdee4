"""BERT encoder + sequence-classification head, the PyTorch twin of
``pdnlp_tpu/models/bert.py``: the serving forward and the training forward.

Where the JAX package scans one step over ``[L, ...]``-stacked weights,
this is an ``nn.ModuleList`` of layers run in a Python loop.  Parameter
names follow the JAX tree (``embeddings.word``, ``layers.<i>.q``,
``attn_ln.scale``, ...) so ``models.convert`` maps one onto the other
leaf by leaf; dense layers are ``nn.Linear`` (weight ``[out, in]``, the
transpose of the JAX ``[in, out]`` kernel).

Precision follows the JAX policy: the compute dtype is the dtype the
caller asks for, LayerNorm reduces in fp32 whatever it is, the embedding
sum is taken in fp32 and then cast, and logits come back in fp32.  Dense
weights are cast to the compute dtype at the matmul (a no-op once the
serving engine has cast them; in training the fp32 master weights are
cast there, so their gradients land in fp32).

Training (``deterministic=False``) drops out, at the JAX package's places:
after the embeddings, after the attention output projection and after the
MLP (before each residual LayerNorm), on the pooled features, and on the
attention probabilities on the plain attention route — the kernels have no
probability dropout, so ``ops.attention`` routes attention dropout > 0 to
the plain path.  The masks are drawn from an explicit ``torch.Generator``
(different numbers from JAX's keys for the same seed).  Autograd runs
through every part, the flash and fused-CE kernels included.

Rematerialization (``remat``, the ``jax.checkpoint`` twin) recomputes each
layer in the backward, with the dropout generator replayed (:func:`_remat`),
eager or inside a captured CUDA graph (:class:`RematRng`).

Int8 weight-only serving swaps each dense layer for a :class:`QuantLinear`
and each expert stack for a :class:`QuantExperts` (:func:`quantize_linears`),
whose branches are the JAX ``qscale`` ones (``_dense``, ``_expert_scale``).

Mixture of experts (``cfg.moe_experts``): each layer's MLP becomes a
:class:`Gate` ``[H, E]`` and two :class:`Experts` stacks, ``up`` ``[E, H,
I]`` and ``down`` ``[E, I, H]`` in the JAX layout (per layer instead of
stacked), run by :func:`moe_mlp`: the fp32 softmax gate, top-k with ties
to the lower index (``jax.lax.top_k``'s order), renormalised combine
weights and the masked Switch aux loss, through the grouped (capacity
slots, static shapes) or the dense dispatch.  ``encode(with_aux=True)``
and ``classify(return_aux=True)`` return the aux summed over the layers.

Tensor and expert parallelism (``parallel.sharding.shard_model``) leave
each layer a ``shards`` record: under ``tp`` the layer holds its share of
the heads and MLP features and runs the Megatron pair
(``parallel.collectives``) around its blocks, under ``ep`` its share of the
experts, whose partial combine is summed over the expert group.

Sequence parallelism (``parallel.sp``): with a ``seq_group`` the batch is
this rank's ``[B, S_local]`` slice of the sequence.  Positions are offset
by the slice's start, attention is ring attention over the group
(``ops.ring``), and the head reads shard 0's [CLS] row (or, for packed
rows, each segment's [CLS] wherever it lies) through a ``psum`` over the
group, so every rank computes the same logits.  MoE layers refuse the ring
path, as in JAX.  Pipeline parallelism (``parallel.pp``) runs the same
layers, a stage's slice at a time.

The masked-LM head (:class:`MLMHead`, :func:`init_mlm_head`,
:func:`mlm_logits`) is its own module beside the classifier, as the JAX
head is its own tree, so classifier checkpoints load into the trunk
unchanged; its decoder is tied to ``embeddings.word``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pdnlp_tpu_torch.models.config import BertConfig
from pdnlp_tpu_torch.ops.attention import dot_product_attention, mask_bias


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm reduced in fp32 whatever the compute dtype (biased
    variance, scale and shift in fp32, then cast back)."""
    return F.layer_norm(x.to(torch.float32), x.shape[-1:], scale, bias,
                        eps).to(x.dtype)


def _gelu(x: torch.Tensor, form: str = "erf") -> torch.Tensor:
    """GELU in ``cfg.gelu`` form: ``"erf"`` exact, ``"tanh"`` approximate."""
    if form not in ("erf", "tanh"):
        raise ValueError(f"gelu must be 'erf' or 'tanh', got {form!r}")
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


class QuantLinear(nn.Module):
    """An int8 weight-only dense block (``serve.quant``): an ``int8``
    ``weight`` ``[out, in]``, an fp32 ``qscale`` ``[out]`` (one per output
    channel) and an fp32 ``bias``, all buffers — a serving module, never
    trained."""

    def __init__(self, out_features: int, in_features: int, device=None):
        super().__init__()
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("qscale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=torch.float32, device=device))


class Gate(nn.Module):
    """The MoE router of one layer: a bias-less ``kernel`` ``[H, E]`` (the
    JAX layout; kept fp32 under int8 serving, as JAX keeps it).  Its
    forward gives the fp32 gate logits ``[B, S, E]``, so a forward hook
    sees each layer's routing."""

    def __init__(self, hidden: int, experts: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(hidden, experts,
                                               device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ self.kernel.to(x.dtype)).to(torch.float32)


class Experts(nn.Module):
    """``E`` stacked dense blocks of one layer: ``kernel`` ``[E, in, out]``
    and ``bias`` ``[E, out]`` (the JAX layout, so no transpose crosses)."""

    def __init__(self, experts: int, fan_in: int, fan_out: int,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(experts, fan_in, fan_out,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(experts, fan_out,
                                             device=device))


class QuantExperts(nn.Module):
    """The int8 form of :class:`Experts` (``serve.quant``): an ``int8``
    ``kernel`` ``[E, in, out]``, an fp32 ``qscale`` ``[E, out]`` (per
    expert, per output channel) and an fp32 ``bias``, all buffers."""

    def __init__(self, experts: int, fan_in: int, fan_out: int,
                 device=None):
        super().__init__()
        self.register_buffer("kernel", torch.zeros(
            experts, fan_in, fan_out, dtype=torch.int8, device=device))
        self.register_buffer("qscale", torch.ones(
            experts, fan_out, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            experts, fan_out, dtype=torch.float32, device=device))


def quantize_linears(model: nn.Module) -> None:
    """Swap every ``nn.Linear`` of ``model`` for a :class:`QuantLinear`
    and every :class:`Experts` for a :class:`QuantExperts` holding its int8
    form (``serve.quant``), in place — JAX's scope: q/k/v/o, up/down (dense
    or expert stacks), pooler and classifier; the MoE gate stays fp32."""
    from pdnlp_tpu_torch.serve.quant import quantize_dense, quantize_kernel

    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear):
                q, s = quantize_dense(child.weight)
                ql = QuantLinear(child.out_features, child.in_features,
                                 device=child.weight.device)
                ql.weight.copy_(q)
                ql.qscale.copy_(s)
                ql.bias.copy_(child.bias.detach().to(torch.float32))
                setattr(parent, name, ql)
            elif isinstance(child, Experts):
                q, s = quantize_kernel(child.kernel)
                qe = QuantExperts(*child.kernel.shape,
                                  device=child.kernel.device)
                qe.kernel.copy_(q)
                qe.qscale.copy_(s)
                qe.bias.copy_(child.bias.detach().to(torch.float32))
                setattr(parent, name, qe)


def _dense(x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
    if isinstance(lin, QuantLinear):
        # int8 weight-only serving (JAX's ``qscale`` branch): the
        # per-OUTPUT-channel scale commutes through the contraction, so it
        # multiplies the [.., out] RESULT.  The int8 weight is cast to the
        # compute dtype here, a copy per call (XLA fuses that convert into
        # the product; this plain product does not)
        y = F.linear(x, lin.weight.to(x.dtype))
        return y * lin.qscale.to(x.dtype) + lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _row_dense(x: torch.Tensor, lin: nn.Module, shards) -> torch.Tensor:
    """A row-split dense block under ``tp``: this rank's partial product
    summed over the model group, then the (replicated) bias, added once."""
    if shards is None or shards.mode != "tp":
        return _dense(x, lin)
    from pdnlp_tpu_torch.parallel.collectives import reduce_from_group

    y = reduce_from_group(F.linear(x, lin.weight.to(x.dtype)), shards.group)
    return y + lin.bias.to(x.dtype)


def _experts(x: torch.Tensor, ex: nn.Module) -> torch.Tensor:
    """``[E, C, in]`` -> ``[E, C, out]``: each expert's product, its int8
    scale on the OUTPUT (JAX's ``_expert_scale``), then its bias."""
    y = torch.matmul(x, ex.kernel.to(x.dtype))
    if isinstance(ex, QuantExperts):
        y = y * ex.qscale.to(x.dtype)[:, None, :]
    return y + ex.bias.to(x.dtype)[:, None, :]


def top_k_lowest(probs: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, ties
    to the lower index, as ``jax.lax.top_k`` orders them (``torch.topk``
    promises no order among equal values on the card)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx[..., None] == arange(n)`` as int64: a one-hot that reads no
    value back to the host (a captured step can hold it)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _gather_sum(table: torch.Tensor, index: torch.Tensor, k: int
                ) -> torch.Tensor:
    """``table`` with a zero row appended, gathered at ``index`` (``[n *
    k]``) and summed over each run of ``k``: ``[n, width]``, in a fixed
    order — no atomics."""
    ext = torch.cat([table, table.new_zeros(1, table.shape[-1])])
    return ext[index].view(-1, k, table.shape[-1]).sum(1)


class _SlotDispatch(torch.autograd.Function):
    """The grouped dispatch's gather, ``x[slot_tok]`` (row ``T`` = zeros),
    whose backward is the same gather-and-sum as the combine's forward:
    token ``t``'s gradient is the sum over its ``k`` assignments' slots, in
    order.  The two maps are inverse on the kept assignments, so neither
    direction needs an atomic add: a captured step equals eager bit for
    bit."""

    @staticmethod
    def forward(ctx, x, slot_tok, slot, k):
        ctx.save_for_backward(slot)
        ctx.k = k
        ext = torch.cat([x, x.new_zeros(1, x.shape[-1])])
        return ext[slot_tok]

    @staticmethod
    def backward(ctx, grad):
        (slot,) = ctx.saved_tensors
        return _gather_sum(grad, slot, ctx.k), None, None, None


class _SlotCombine(torch.autograd.Function):
    """The grouped combine: token ``t``'s output is the sum over its ``k``
    assignments of their (weighted) slot rows, in order; the backward
    gathers each slot's row of the output gradient (``x[slot_tok]``)."""

    @staticmethod
    def forward(ctx, y, slot, slot_tok, k):
        ctx.save_for_backward(slot_tok)
        return _gather_sum(y, slot, k)

    @staticmethod
    def backward(ctx, grad):
        (slot_tok,) = ctx.saved_tensors
        ext = torch.cat([grad, grad.new_zeros(1, grad.shape[-1])])
        return ext[slot_tok], None, None, None


def route(gate_logits: torch.Tensor, k: int):
    """The routing both dispatches share: ``(probs, top_idx, renorm)`` —
    the fp32 softmax of the gate logits ``[B, S, E]``, the top ``k``
    experts of each token (ties to the lower index) and their combine
    weights renormalised over them."""
    probs = torch.softmax(gate_logits, -1)
    top_p, top_idx = top_k_lowest(probs, k)                 # [B, S, k]
    renorm = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_idx, renorm


class Slots(NamedTuple):
    """The grouped dispatch's slot assignment (:func:`grouped_slots`), per
    assignment ``[T * k]``, token-major."""
    expert: torch.Tensor      # its expert
    pos: torch.Tensor         # its rank among this rank's to its expert
    routed: torch.Tensor      # a real token's (padding routes nowhere)
    kept: torch.Tensor        # routed and within the expert's capacity
    width: int                # the slots a buffer holds per expert


def grouped_slots(top_idx: torch.Tensor, mask: Optional[torch.Tensor],
                  experts: int, capacity_factor: float,
                  group=None) -> Slots:
    """Which assignments of ``top_idx`` (``[B, S, k]``) keep an expert
    slot, as JAX's ``_moe_grouped`` decides: ranked token-major by the
    GShard position-in-expert cumsum, an assignment keeps its slot iff
    its position is below ``C = min(ceil(cf * k * T / E), T)``; padding
    (``mask`` 0) never takes one.  Nothing reads a routing-dependent size
    back, so a captured step can hold it.

    With a data ``group`` the batch is the group's global one, its rows in
    rank order, as JAX's jitted step sees it: ``T`` counts every rank's
    tokens (each holds the same number), and an assignment's position adds
    the routed assignments of the ranks before this one to its expert (an
    all-reduce of ``D * E`` counts).  Its slot in this rank's buffers is
    its rank among this rank's own, below ``min(C, T)``."""
    B, S, k = top_idx.shape
    T = B * S
    dev = top_idx.device
    expert = top_idx.reshape(-1)                              # [T * k]
    routed = torch.ones(T * k, dtype=torch.bool, device=dev)
    if mask is not None:
        routed = mask.reshape(T, 1).to(torch.bool).expand(T, k).reshape(-1)
    # the cumsum runs along the last axis of an [E, T * k] table: a scan
    # down the first axis of [T * k, E] takes one thread per column on the
    # card (~1.3 ms a layer at 32 x 128)
    onehot = (_one_hot(expert, experts) * routed[:, None]).t().contiguous()
    csum = onehot.cumsum(1)
    pos = (csum - onehot).gather(0, expert[None, :])[0]
    ranks = 1 if group is None else dist.get_world_size(group)
    C = min(int(math.ceil(capacity_factor * k * ranks * T / experts)),
            ranks * T)
    gpos = pos
    if ranks > 1:
        me = dist.get_rank(group)
        table = torch.zeros(ranks, experts, dtype=torch.float32, device=dev)
        table[me] = csum[:, -1].to(torch.float32)
        dist.all_reduce(table, group=group)
        before = table[:me].sum(0).to(torch.long)             # [E]
        gpos = pos + before[expert]
    return Slots(expert, pos, routed, routed & (gpos < C), min(C, T))


def moe_mlp(x: torch.Tensor, layer: "EncoderLayer", cfg: BertConfig,
            mask: Optional[torch.Tensor] = None):
    """One layer's top-k gated mixture-of-experts MLP (JAX ``moe_mlp``):
    ``[B, S, H]`` -> ``(out [B, S, H], aux)``.

    The routing is the same for both dispatches and every rank
    (:func:`route`), and the Switch load-balancing aux is ``E *
    sum(token_frac * prob_frac)`` over the real tokens (``mask``, ``[B,
    S]``; 1.0 = balanced).  ``cfg.moe_dispatch``: ``"grouped"`` (capacity
    slots, :func:`_moe_grouped`) or ``"dense"`` (every expert on every
    token; exact, O(E): the parity oracle).  With ``layer.data_group`` (the
    jit strategies over several data ranks) the aux's statistics and the
    grouped dispatch's capacity are the global batch's, as in JAX's jitted
    step.

    Under ``ep`` (``layer.shards``) the layer holds experts ``[e0, e0 +
    E_local)``: it computes their part of the combine, and the parts are
    summed over the expert group; ``x`` and the combine weights enter
    through ``copy_to_group``, so their gradients are summed too, while the
    gate, the routing and the aux, replicated, get the whole gradient on
    every rank."""
    dtype = x.dtype
    E = layer.gate.kernel.shape[-1]
    probs, top_idx, renorm = route(layer.gate(x), min(cfg.moe_top_k, E))
    if cfg.moe_dispatch not in ("grouped", "dense"):
        raise ValueError(
            f"moe_dispatch={cfg.moe_dispatch!r} — use 'grouped' or 'dense'; "
            "a silent fallback would quietly benchmark the O(E) path")
    shards = layer.shards
    ep = shards is not None and shards.mode == "ep"
    e0 = shards.index * layer.up.kernel.shape[0] if ep else 0
    xin, win = x, renorm
    if ep:
        from pdnlp_tpu_torch.parallel.collectives import copy_to_group

        xin, win = copy_to_group(x, shards.group), copy_to_group(
            renorm, shards.group)
    group = layer.data_group
    if cfg.moe_dispatch == "grouped":
        slots = grouped_slots(top_idx, mask, E, cfg.moe_capacity_factor,
                              group)
        out = _moe_grouped(xin, layer, slots, win, cfg, e0)
    else:
        El = layer.up.kernel.shape[0]
        onehot = _one_hot(top_idx, E).to(torch.float32)    # [B, S, k, E]
        combine = torch.einsum("bske,bsk->bse", onehot, win)
        B, S, H = x.shape
        h = _gelu(_experts(xin.reshape(1, B * S, H).expand(El, -1, -1),
                           layer.up), cfg.gelu)
        y = _experts(h, layer.down).view(El, B, S, H)
        out = torch.einsum("ebsh,bse->bsh", y,
                           combine[..., e0: e0 + El].to(dtype))
    if ep:
        from pdnlp_tpu_torch.parallel.collectives import reduce_from_group

        out = reduce_from_group(out, shards.group)
    top1 = _one_hot(top_idx[..., 0], E).to(torch.float32).reshape(-1, E)
    p2 = probs.reshape(-1, E)
    if mask is None and group is None:
        token_frac = top1.mean(0)
        prob_frac = p2.mean(0)
    else:
        m = (torch.ones_like(p2[:, :1]) if mask is None
             else mask.to(torch.float32).reshape(-1, 1))
        sums = torch.cat([(top1 * m).sum(0), (p2 * m).sum(0),
                          m.sum().reshape(1)])
        if group is not None:
            # the global batch's statistics, as JAX's jitted step has them
            from pdnlp_tpu_torch.parallel.collectives import (
                reduce_from_group,
            )

            sums = reduce_from_group(sums, group)
        denom = sums[-1].clamp_min(1.0)
        token_frac = sums[:E] / denom
        prob_frac = sums[E: 2 * E] / denom
    return out, E * (token_frac * prob_frac).sum()


def _moe_grouped(x, layer, slots: Slots, renorm, cfg, e0):
    """Capacity-based dispatch (JAX ``_moe_grouped``), static shapes end to
    end, on the slots of :func:`grouped_slots`.  Slot tables ``[E_local,
    width]`` hold the source token (sentinel ``T``: a zero row) and the
    combine weight; the experts run as batched products over their
    ``[width, H]`` buffers; the combine sums each token's kept slots in
    order (:class:`_SlotCombine`).  Dropped assignments add nothing (the
    caller's residual carries the token)."""
    B, S, H = x.shape
    T = B * S
    El = layer.up.kernel.shape[0]
    k = slots.expert.numel() // T
    W = slots.width
    dev = x.device
    flat_e = slots.expert
    local = slots.kept & (flat_e >= e0) & (flat_e < e0 + El)
    dump = El * W
    slot = torch.where(local, (flat_e - e0) * W + slots.pos,
                       torch.full_like(flat_e, dump))         # [T * k]
    tok = torch.arange(T * k, device=dev) // k
    slot_tok = torch.full((dump + 1,), T, dtype=torch.long,
                          device=dev).scatter(0, slot, tok)[:dump]
    slot_w = torch.zeros(dump + 1, dtype=torch.float32, device=dev).scatter(
        0, slot, renorm.reshape(-1))[:dump]
    xe = _SlotDispatch.apply(x.reshape(T, H), slot_tok, slot, k)
    h = _gelu(_experts(xe.view(El, W, H), layer.up), cfg.gelu)
    y = _experts(h, layer.down) * slot_w.view(El, W, 1).to(x.dtype)
    out = _SlotCombine.apply(y.reshape(dump, H), slot, slot_tok, k)
    return out.view(B, S, H)


def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep with probability ``1 - rate`` and scale by
    ``1 / (1 - rate)``; identity at rate 0 or without a generator (the
    deterministic forward)."""
    if rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


class LayerNorm(nn.Module):
    """The JAX ``{"scale", "bias"}`` LayerNorm leaf pair (kept fp32)."""

    def __init__(self, width: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width, device=device))
        self.bias = nn.Parameter(torch.zeros(width, device=device))


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        H = cfg.hidden_size
        self.word = nn.Parameter(torch.empty(cfg.vocab_size, H, device=device))
        self.position = nn.Parameter(
            torch.empty(cfg.max_position, H, device=device))
        self.token_type = nn.Parameter(
            torch.empty(cfg.type_vocab_size, H, device=device))
        self.ln = LayerNorm(H, device)


class EncoderLayer(nn.Module):
    """One post-LN encoder block.  Its body runs in :meth:`forward`, so a
    wrapper that acts through a module's forward (``torch.utils.
    checkpoint``) sees every layer.  An MoE layer
    (``cfg.moe_experts``) holds ``gate``, ``up`` and ``down`` as
    :class:`Gate` and :class:`Experts`, and its forward returns ``(x,
    aux)``.  ``shards`` (``parallel.sharding.ModelShards``, None on one
    device) says which share of the heads, MLP features or experts the
    layer holds."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts
        self.q = nn.Linear(H, H, device=device)
        self.k = nn.Linear(H, H, device=device)
        self.v = nn.Linear(H, H, device=device)
        self.o = nn.Linear(H, H, device=device)
        self.attn_ln = LayerNorm(H, device)
        if E:
            self.gate = Gate(H, E, device)
            self.up = Experts(E, H, I, device)
            self.down = Experts(E, I, H, device)
        else:
            self.up = nn.Linear(H, I, device=device)
            self.down = nn.Linear(I, H, device=device)
        self.mlp_ln = LayerNorm(H, device)
        self.shards = None
        #: the data group whose global batch the routing's statistics and
        #: capacity are over (the jit strategies; ``train.steps.
        #: TrainObjective``)
        self.data_group = None

    @property
    def moe(self) -> bool:
        return bool(self.cfg.moe_experts)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, *,
                attn_impl: str = "auto",
                generator: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None, seq_group=None):
        """``[B, S, H]`` -> ``[B, S, H]``: attention (key ``bias`` or
        packed ``segment_ids``), output projection, residual LayerNorm, MLP,
        residual LayerNorm; dropout with a ``generator``.  An MoE layer
        returns ``(x, aux)``; ``mask`` (``[B, S]``) keeps padding out of its
        routing statistics and capacity slots.  With a ``seq_group`` ``x``
        is this rank's slice of the sequence and attention runs the ring
        over the group (``bias`` then is the ``[B, S_local]`` key bias)."""
        cfg = self.cfg
        B, S, _ = x.shape
        D = cfg.head_dim
        drop = cfg.dropout
        attn_drop = cfg.attn_dropout if generator is not None else 0.0
        sh = self.shards
        tp = sh is not None and sh.mode == "tp"
        xin = x
        if tp:
            from pdnlp_tpu_torch.parallel.collectives import copy_to_group

            xin = copy_to_group(x, sh.group)
        q = _dense(xin, self.q)
        N = q.shape[-1] // D                 # this rank's heads under tp
        q = q.view(B, S, N, D)
        k = _dense(xin, self.k).view(B, S, N, D)
        v = _dense(xin, self.v).view(B, S, N, D)
        if seq_group is not None:
            from pdnlp_tpu_torch.ops.ring import ring_attention

            attn = ring_attention(q, k, v, bias, seq_group,
                                  dropout_rate=attn_drop,
                                  generator=generator,
                                  segment_ids=segment_ids)
        else:
            attn = dot_product_attention(q, k, v, bias, impl=attn_impl,
                                         segment_ids=segment_ids,
                                         dropout_rate=attn_drop,
                                         generator=generator)
        attn = _row_dense(attn.reshape(B, S, N * D), self.o, sh)
        x = _layer_norm(x + _dropout(attn, drop, generator),
                        self.attn_ln.scale, self.attn_ln.bias,
                        cfg.layer_norm_eps)
        aux = None
        if self.moe:
            h, aux = moe_mlp(x, self, cfg, mask)
        else:
            xin = copy_to_group(x, sh.group) if tp else x
            h = _row_dense(_gelu(_dense(xin, self.up), cfg.gelu), self.down,
                           sh)
        x = _layer_norm(x + _dropout(h, drop, generator),
                        self.mlp_ln.scale, self.mlp_ln.bias,
                        cfg.layer_norm_eps)
        return x if aux is None else (x, aux)


class RematRng:
    """The recompute's dropout streams for one captured graph.

    Eager, :func:`_remat` saves the generator's state on the host and puts
    it back for the recompute.  A captured graph cannot do that: the
    generator's offset under capture is a device value read at each replay,
    and a host read or write of it would be frozen into the capture.  So
    the captured step draws each layer's recompute from a state of its own
    (``states``, one per remat call in the graph, each registered with the
    graph before the capture), switched in and out with the graph-safe
    generator API; before every replay the capturer sets each one to the
    offset the main generator will have at that layer's forward
    (``train.steps._MultiStep``), which an eager recording step measured
    (``offsets``: the main generator's offset at each remat forward).
    Each replay's recompute then draws the masks its forward drew."""

    def __init__(self, states=()):
        self.states = list(states)
        self.offsets: List[int] = []


#: ``.rng``: the :class:`RematRng` of the capture or recording step under
#: way on this thread (a gang's ranks may be threads of one process)
_REMAT = threading.local()


@contextlib.contextmanager
def remat_rng(rng: RematRng):
    """Route :func:`_remat`'s dropout bookkeeping through ``rng`` while the
    block runs (a capture, or the eager step that records the offsets)."""
    prev, _REMAT.rng = getattr(_REMAT, "rng", None), rng
    try:
        yield rng
    finally:
        _REMAT.rng = prev


def _remat(layer: EncoderLayer, x: torch.Tensor, *args,
           generator: Optional[torch.Generator], **kw) -> torch.Tensor:
    """``layer(x, ...)`` under ``torch.utils.checkpoint``: its activations
    are dropped after the forward and recomputed in the backward.

    ``checkpoint``'s ``preserve_rng_state`` restores only the default CPU
    and CUDA streams, and dropout draws from the explicit ``generator``:
    left alone, the recompute would draw other masks and the gradient would
    be silently wrong.  So the recompute replays the forward's masks
    (``jax.checkpoint`` replays its keys for free): eager, the generator's
    state is saved here, restored at the start of the recompute, and the
    stream put back where the backward found it afterwards; under a CUDA
    graph capture the recompute draws from the next state of the capture's
    :class:`RematRng`, which each replay starts at this forward's offset.
    Nothing on this path draws from the default streams.

    The recompute reads the weights the forward read: the layer's own, or
    the tensors a ``torch.func.functional_call`` put in their place for
    the forward (zero's gathered weights, ``parallel.sharding.
    ZeroObjective``; the bf16 casts of ``--grads_dtype compute``), which
    are gone from the module by the backward."""
    from torch.utils.checkpoint import checkpoint

    saved = replay = None
    rng = getattr(_REMAT, "rng", None)
    if generator is not None and generator.device.type == "cuda" \
            and torch.cuda.is_current_stream_capturing():
        if rng is None or not rng.states:
            raise RuntimeError(
                "remat in a captured region needs the recompute's dropout "
                "states (train.steps.build_multi_step captures it)")
        replay = rng.states.pop(0)
    elif generator is not None:
        saved = generator.get_state()
        if rng is not None:
            rng.offsets.append(generator.get_offset())
    weights = dict(layer.named_parameters())
    ran = []

    def body(x):
        if not ran:                       # the forward itself
            ran.append(True)
            return layer(x, *args, generator=generator, **kw)
        now = None                        # the recompute: replay the masks
        if replay is not None:
            now = generator.graphsafe_get_state()
            generator.graphsafe_set_state(replay)
        elif saved is not None:
            now = generator.get_state()
            generator.set_state(saved)
        try:
            return torch.func.functional_call(
                layer, weights, (x, *args), {"generator": generator, **kw})
        finally:
            if replay is not None:
                generator.graphsafe_set_state(now)
            elif now is not None:
                generator.set_state(now)

    return checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)


class MLMHead(nn.Module):
    """The masked-LM head (``bert.init_mlm_head``'s tree): a dense
    ``transform``, GELU, the LayerNorm ``ln``, then a decoder TIED to the
    trunk's word embeddings plus a per-token ``bias``.  The word matrix is
    the trunk's, so the head holds no copy of it."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.transform = nn.Linear(H, H, device=device)
        self.ln = LayerNorm(H, device)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))


@torch.no_grad()
def init_mlm_head(cfg: BertConfig, *,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> MLMHead:
    """A fresh :class:`MLMHead`: truncated normal (+-2 std) transform,
    zero biases, unit LayerNorm — the JAX ``init_mlm_head`` scheme (other
    draws: the generators differ)."""
    head = MLMHead(cfg, device)
    std = cfg.initializer_range
    nn.init.trunc_normal_(head.transform.weight, std=std, a=-2 * std,
                          b=2 * std, generator=generator)
    head.transform.bias.zero_()
    return head


def mlm_logits(model: "BertClassifier", head: MLMHead, hidden: torch.Tensor,
               *, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, S, H]`` hidden states -> ``[B, S, vocab]`` fp32 logits: the
    transform, GELU and LayerNorm, then the tied decoder
    (``embeddings.word`` cast to the compute dtype) plus the bias."""
    cfg = head.cfg
    h = _gelu(_dense(hidden, head.transform), cfg.gelu)
    h = _layer_norm(h, head.ln.scale, head.ln.bias, cfg.layer_norm_eps)
    word = model.embeddings.word.to(dtype)
    logits = torch.einsum("bsh,vh->bsv", h, word) + head.bias.to(dtype)
    return logits.to(torch.float32)


class BertClassifier(nn.Module):
    """BERT encoder, tanh pooler and classifier (``bert.classify``)."""

    def __init__(self, cfg: BertConfig, *,
                 generator: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.embeddings = Embeddings(cfg, device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self.pooler = nn.Linear(H, H, device=device)
        self.classifier = nn.Linear(H, cfg.num_labels, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Truncated normal (+-2 std, std ``initializer_range``) for every
        matrix, zeros for biases, ones/zeros for LayerNorm — the JAX
        ``init_params`` scheme (different draws: the generators differ)."""
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            else:
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)

    # ------------------------------------------------------------ forward
    def embed(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
              dtype: torch.dtype,
              position_ids: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              shard_offset: int = 0) -> torch.Tensor:
        """Embedding sum (fp32) -> compute dtype -> LayerNorm -> dropout
        (with a ``generator``).  Explicit ``position_ids`` (packed rows
        restart per segment) carry their own bound; row positions must fit
        the table.  ``shard_offset`` is the first row position of a
        sequence slice (sequence parallelism)."""
        emb = self.embeddings
        S = input_ids.shape[1]
        if position_ids is None:
            if shard_offset + S > self.cfg.max_position:
                raise ValueError(
                    f"sequence length {shard_offset + S} exceeds "
                    f"max_position {self.cfg.max_position}")
            pos = emb.position[shard_offset: shard_offset + S][None]
        else:
            pos = emb.position[position_ids.long()]
        x = (emb.word[input_ids.long()] + pos
             + emb.token_type[token_type_ids.long()]).to(dtype)
        x = _layer_norm(x, emb.ln.scale, emb.ln.bias, self.cfg.layer_norm_eps)
        return _dropout(x, self.cfg.dropout, generator)

    def encode(self, input_ids, token_type_ids, attention_mask, *,
               dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
               segment_ids: Optional[torch.Tensor] = None,
               position_ids: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               remat: bool = False, with_aux: bool = False,
               seq_group=None):
        """Hidden states ``[B, S, H]`` in ``dtype``.  ``segment_ids`` (packed
        rows) carries the block-diagonal mask to attention; otherwise the
        key mask comes from ``attention_mask``.  A ``generator`` turns on
        dropout (training).  ``remat`` recomputes each layer's activations
        in the backward instead of keeping them (:func:`_remat`).
        ``with_aux`` returns ``(hidden, aux)``: the MoE load-balancing
        loss summed over the layers (fp32; 0 for a dense model).  With a
        ``seq_group`` the inputs are this rank's slice of the sequence
        (JAX ``encode``'s ``seq_axis``): positions start at the slice's
        offset and attention runs the ring."""
        shard_offset = 0
        if seq_group is not None:
            from pdnlp_tpu_torch.parallel.collectives import world_size

            if self.cfg.moe_experts:
                raise ValueError("MoE layers are not supported on the "
                                 "sequence-parallel (ring attention) path")
            S = input_ids.shape[1]
            shard_offset = torch.distributed.get_rank(seq_group) * S
            if position_ids is None and \
                    S * world_size(seq_group) > self.cfg.max_position:
                raise ValueError("global sequence exceeds max_position")
        x = self.embed(input_ids, token_type_ids, dtype, position_ids,
                       generator, shard_offset)
        if segment_ids is not None:
            bias = None
        elif seq_group is not None:
            # the same additive mask, squeezed to the [B, S_local] rows the
            # ring rotates with its K/V block
            bias = mask_bias(attention_mask)[:, 0, 0, :]
        else:
            # fp32 whatever the compute dtype: the kernel adds the mask in
            # fp32, and the plain path casts it to the scores' dtype
            bias = mask_bias(attention_mask)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ring = {} if seq_group is None else {"seq_group": seq_group}
        for layer in self.layers:
            if remat and torch.is_grad_enabled():
                out = _remat(layer, x, bias, segment_ids, attn_impl=attn_impl,
                             generator=generator, mask=attention_mask, **ring)
            else:
                out = layer(x, bias, segment_ids, attn_impl=attn_impl,
                            generator=generator, mask=attention_mask, **ring)
            if layer.moe:
                x, a = out
                aux = aux + a
            else:
                x = out
        return (x, aux) if with_aux else x

    def pooled_features(self, h0: torch.Tensor,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """[CLS] hidden rows ``[B, H]`` -> pooled pre-classifier features
        (tanh pooler, then dropout with a ``generator``): the input of the
        fused classifier + CE kernels, which apply the classifier
        themselves."""
        pooled = torch.tanh(_dense(h0, self.pooler))
        return _dropout(pooled, self.cfg.dropout, generator)

    def pooled_logits(self, h0: torch.Tensor,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """[CLS] hidden rows ``[B, H]`` -> fp32 logits ``[B, num_labels]``."""
        return _dense(self.pooled_features(h0, generator),
                      self.classifier).to(torch.float32)

    def forward(self, batch: Dict[str, torch.Tensor], **kw) -> torch.Tensor:
        """:meth:`classify`, so ``torch.func.functional_call`` can run the
        model on other weights (the EMA)."""
        return self.classify(batch, **kw)

    def classify(self, batch: Dict[str, torch.Tensor], *,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", deterministic: bool = True,
                 generator: Optional[torch.Generator] = None,
                 return_pooled: bool = False,
                 remat: bool = False, return_aux: bool = False,
                 seq_group=None):
        """fp32 logits: ``[B, num_labels]`` for a padded batch, or
        ``[B, M, num_labels]`` per segment for a packed batch (one carrying
        ``cls_positions``, ``segment_ids`` and ``position_ids``).

        ``deterministic=False`` is the training forward: dropout drawn from
        ``generator`` (required).  ``return_pooled`` returns the pooled
        features (``[B, H]`` / ``[B, M, H]``, in ``dtype``) instead of
        logits, for ``ops.fused_ce``.  ``remat``: see :meth:`encode`.
        ``return_aux`` returns ``(out, aux)``, the MoE load-balancing loss
        summed over the layers (0 for a dense model).

        With a ``seq_group`` (sequence parallelism) the batch's token
        channels are this rank's slice of the sequence: shard 0's [CLS] row
        is broadcast by a masked ``psum`` over the group, and a packed
        batch's global ``cls_positions`` are gathered from the slice each
        lands in, the same way (JAX ``classify``'s ``seq_axis``); every
        rank then computes the same head."""
        if not deterministic and generator is None:
            raise ValueError("the training forward (deterministic=False) "
                             "draws dropout from an explicit generator")
        gen = None if deterministic else generator
        packed = "cls_positions" in batch
        hidden, aux = self.encode(
            batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"], dtype=dtype, attn_impl=attn_impl,
            segment_ids=batch["segment_ids"] if packed else None,
            position_ids=batch.get("position_ids") if packed else None,
            generator=gen, remat=remat, with_aux=True, seq_group=seq_group)
        head = self.pooled_features if return_pooled else self.pooled_logits
        if seq_group is not None:
            from pdnlp_tpu_torch.parallel.collectives import psum

            me = torch.distributed.get_rank(seq_group)
        if not packed:
            h0 = hidden[:, 0, :]
            if seq_group is not None:
                h0 = psum(h0 * float(me == 0), seq_group)
            out = head(h0, gen)
        else:
            pos = batch["cls_positions"].long()
            if seq_group is None:
                hM = torch.take_along_dim(hidden, pos[..., None], dim=1)
            else:
                # the offsets are global, ``hidden`` this rank's slice: each
                # rank gathers the offsets inside its slice, the psum
                # assembles the [B, M, H] rows on every rank
                S_local = hidden.shape[1]
                local = pos - me * S_local
                inb = (local >= 0) & (local < S_local)
                hM = torch.take_along_dim(
                    hidden, local.clamp(0, S_local - 1)[..., None], dim=1)
                hM = psum(hM * inb[..., None].to(hidden.dtype), seq_group)
            B, M, H = hM.shape                                 # [B, M, H]
            out = head(hM.reshape(B * M, H), gen).reshape(B, M, -1)
        return (out, aux) if return_aux else out
