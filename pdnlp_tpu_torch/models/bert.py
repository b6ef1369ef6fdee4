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
layer in the backward, with the dropout generator replayed (:func:`_remat`).

Int8 weight-only serving swaps each dense layer for a :class:`QuantLinear`
(:func:`quantize_linears`), whose ``_dense`` branch is the JAX ``qscale``
one.  Not in this slice, and refused rather than approximated: MoE layers
and sequence-parallel (ring) attention.

The masked-LM head (:class:`MLMHead`, :func:`init_mlm_head`,
:func:`mlm_logits`) is its own module beside the classifier, as the JAX
head is its own tree, so classifier checkpoints load into the trunk
unchanged; its decoder is tied to ``embeddings.word``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
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


def quantize_linears(model: nn.Module) -> None:
    """Swap every ``nn.Linear`` of ``model`` for a :class:`QuantLinear`
    holding its int8 form (``serve.quant.quantize_dense``), in place —
    JAX's scope: q/k/v/o, up/down, pooler and classifier."""
    from pdnlp_tpu_torch.serve.quant import quantize_dense

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
    wrapper that acts through a module's forward (FSDP2's per-layer
    unshard, ``torch.utils.checkpoint``) sees every layer."""

    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.q = nn.Linear(H, H, device=device)
        self.k = nn.Linear(H, H, device=device)
        self.v = nn.Linear(H, H, device=device)
        self.o = nn.Linear(H, H, device=device)
        self.attn_ln = LayerNorm(H, device)
        self.up = nn.Linear(H, I, device=device)
        self.down = nn.Linear(I, H, device=device)
        self.mlp_ln = LayerNorm(H, device)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None, *,
                attn_impl: str = "auto",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, S, H]`` -> ``[B, S, H]``: attention (key ``bias`` or
        packed ``segment_ids``), output projection, residual LayerNorm, MLP,
        residual LayerNorm; dropout with a ``generator``."""
        cfg = self.cfg
        B, S, _ = x.shape
        N, D = cfg.num_heads, cfg.head_dim
        drop = cfg.dropout
        attn_drop = cfg.attn_dropout if generator is not None else 0.0
        q = _dense(x, self.q).view(B, S, N, D)
        k = _dense(x, self.k).view(B, S, N, D)
        v = _dense(x, self.v).view(B, S, N, D)
        attn = dot_product_attention(q, k, v, bias, impl=attn_impl,
                                     segment_ids=segment_ids,
                                     dropout_rate=attn_drop,
                                     generator=generator)
        attn = _dense(attn.reshape(B, S, N * D), self.o)
        x = _layer_norm(x + _dropout(attn, drop, generator),
                        self.attn_ln.scale, self.attn_ln.bias,
                        cfg.layer_norm_eps)
        h = _dense(_gelu(_dense(x, self.up), cfg.gelu), self.down)
        return _layer_norm(x + _dropout(h, drop, generator),
                           self.mlp_ln.scale, self.mlp_ln.bias,
                           cfg.layer_norm_eps)


def _remat(layer: EncoderLayer, x: torch.Tensor, *args,
           generator: Optional[torch.Generator], **kw) -> torch.Tensor:
    """``layer(x, ...)`` under ``torch.utils.checkpoint``: its activations
    are dropped after the forward and recomputed in the backward.

    ``checkpoint``'s ``preserve_rng_state`` restores only the default CPU
    and CUDA streams, and dropout draws from the explicit ``generator``:
    left alone, the recompute would draw other masks and the gradient would
    be silently wrong.  So the generator's state is saved here, restored
    at the start of the recompute, and the stream put back where the
    backward found it afterwards (``jax.checkpoint`` replays its keys for
    free).  Nothing on this path draws from the default streams."""
    from torch.utils.checkpoint import checkpoint

    saved = generator.get_state() if generator is not None else None
    ran = []

    def body(x):
        if not ran or saved is None:      # the forward itself
            ran.append(True)
            return layer(x, *args, generator=generator, **kw)
        now = generator.get_state()       # the recompute: replay the masks
        generator.set_state(saved)
        try:
            return layer(x, *args, generator=generator, **kw)
        finally:
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
        if cfg.moe_experts:
            raise ValueError("MoE layers are not ported yet (ROADMAP A11)")
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
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Embedding sum (fp32) -> compute dtype -> LayerNorm -> dropout
        (with a ``generator``).  Explicit ``position_ids`` (packed rows
        restart per segment) carry their own bound; row positions must fit
        the table."""
        emb = self.embeddings
        S = input_ids.shape[1]
        if position_ids is None:
            if S > self.cfg.max_position:
                raise ValueError(
                    f"sequence length {S} exceeds max_position "
                    f"{self.cfg.max_position}")
            pos = emb.position[:S][None]
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
               remat: bool = False) -> torch.Tensor:
        """Hidden states ``[B, S, H]`` in ``dtype``.  ``segment_ids`` (packed
        rows) carries the block-diagonal mask to attention; otherwise the
        key mask comes from ``attention_mask``.  A ``generator`` turns on
        dropout (training).  ``remat`` recomputes each layer's activations
        in the backward instead of keeping them (:func:`_remat`)."""
        x = self.embed(input_ids, token_type_ids, dtype, position_ids,
                       generator)
        # fp32 whatever the compute dtype: the kernel adds the mask in fp32,
        # and the plain path casts it to the scores' dtype
        bias = None if segment_ids is not None else mask_bias(attention_mask)
        for layer in self.layers:
            if remat and torch.is_grad_enabled():
                x = _remat(layer, x, bias, segment_ids, attn_impl=attn_impl,
                           generator=generator)
            else:
                x = layer(x, bias, segment_ids, attn_impl=attn_impl,
                          generator=generator)
        return x

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
                 remat: bool = False) -> torch.Tensor:
        """fp32 logits: ``[B, num_labels]`` for a padded batch, or
        ``[B, M, num_labels]`` per segment for a packed batch (one carrying
        ``cls_positions``, ``segment_ids`` and ``position_ids``).

        ``deterministic=False`` is the training forward: dropout drawn from
        ``generator`` (required).  ``return_pooled`` returns the pooled
        features (``[B, H]`` / ``[B, M, H]``, in ``dtype``) instead of
        logits, for ``ops.fused_ce``.  ``remat``: see :meth:`encode`."""
        if not deterministic and generator is None:
            raise ValueError("the training forward (deterministic=False) "
                             "draws dropout from an explicit generator")
        gen = None if deterministic else generator
        packed = "cls_positions" in batch
        hidden = self.encode(
            batch["input_ids"], batch["token_type_ids"],
            batch["attention_mask"], dtype=dtype, attn_impl=attn_impl,
            segment_ids=batch["segment_ids"] if packed else None,
            position_ids=batch.get("position_ids") if packed else None,
            generator=gen, remat=remat)
        head = self.pooled_features if return_pooled else self.pooled_logits
        if not packed:
            return head(hidden[:, 0, :], gen)
        pos = batch["cls_positions"].long()
        hM = torch.take_along_dim(hidden, pos[..., None], dim=1)  # [B, M, H]
        B, M, H = hM.shape
        return head(hM.reshape(B * M, H), gen).reshape(B, M, -1)
