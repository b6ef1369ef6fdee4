"""Plain PyTorch reference of the fine-tuning step: a post-LN BERT encoder
over packed rows (dense FFN or a top-k mixture of experts with capacity
slots), tanh pooler, classifier, example-weighted cross-entropy, autograd's
backward and a hand-written decoupled AdamW.

It computes in float32 (``precision="fp32"``; the caller turns TF32 off)
or, as the correctness control, with every matrix product's operands
rounded to float8 e4m3 under a per-tensor scale (``precision="fp8"``),
forward and backward; ``precision="bf16"`` rounds them to bfloat16
instead, a witness of what the configuration's compute type alone does
to each number compared.  Dropout masks are drawn from the generator the
caller passes, one ``torch.rand`` of each dropped tensor's shape, in the
order of the dropout points: after the embeddings, after each layer's
attention output and its FFN, and on the pooled features.

The MoE layer's discrete decisions can be taken from another run's gate
logits (:class:`Routing`): the reference then routes each token as those
logits rank its experts and keeps the slots that ranking keeps, while its
combine weights, aux loss and gradients come from its own gate.  How far
each decision lies below the reference's own top ``k`` is recorded.

Parameters are a flat ``{name: tensor}`` mapping laid out by
:func:`param_shapes`.  Nothing here imports the program under test.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

FP8_MAX = 448.0


def param_shapes(cfg: Dict) -> "OrderedDict[str, Tuple[tuple, str]]":
    """``{name: (shape, kind)}``; kind is ``matrix`` (decayed, drawn from a
    normal), ``bias`` or ``scale`` (LayerNorm: ones)."""
    H, I, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    E = cfg.get("moe_experts", 0)
    out: "OrderedDict[str, Tuple[tuple, str]]" = OrderedDict()
    out["embeddings.word"] = ((cfg["vocab_size"], H), "matrix")
    out["embeddings.position"] = ((cfg["max_position_embeddings"], H),
                                  "matrix")
    out["embeddings.token_type"] = ((cfg["type_vocab_size"], H), "matrix")
    out["embeddings.ln.scale"] = ((H,), "scale")
    out["embeddings.ln.bias"] = ((H,), "bias")
    for i in range(L):
        p = f"layers.{i}."
        for n in "qkvo":
            out[p + n + ".weight"] = ((H, H), "matrix")
            out[p + n + ".bias"] = ((H,), "bias")
        out[p + "attn_ln.scale"] = ((H,), "scale")
        out[p + "attn_ln.bias"] = ((H,), "bias")
        if E:
            out[p + "gate.kernel"] = ((H, E), "matrix")
            out[p + "up.kernel"] = ((E, H, I), "matrix")
            out[p + "up.bias"] = ((E, I), "bias")
            out[p + "down.kernel"] = ((E, I, H), "matrix")
            out[p + "down.bias"] = ((E, H), "bias")
        else:
            out[p + "up.weight"] = ((I, H), "matrix")
            out[p + "up.bias"] = ((I,), "bias")
            out[p + "down.weight"] = ((H, I), "matrix")
            out[p + "down.bias"] = ((H,), "bias")
        out[p + "mlp_ln.scale"] = ((H,), "scale")
        out[p + "mlp_ln.bias"] = ((H,), "bias")
    out["pooler.weight"] = ((H, H), "matrix")
    out["pooler.bias"] = ((H,), "bias")
    out["classifier.weight"] = ((cfg["num_labels"], H), "matrix")
    out["classifier.bias"] = ((cfg["num_labels"],), "bias")
    return out


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one per-tensor scale."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with both operands, and in the backward the incoming
    gradient, rounded by ``rnd`` first; the products accumulate in
    float32."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        qa, qb = rnd(a), rnd(b)
        ctx.save_for_backward(qa, qb)
        ctx.rnd = rnd
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.rnd(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # broadcast batch dimensions back to each operand's shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb, None


#: the precisions of the products: float32, and the products' operands
#: rounded to bfloat16 (the witness of what the configuration's compute
#: type does by itself) or to float8 e4m3 (the control)
ROUNDING = {"fp32": None, "bf16": _bf16, "fp8": _fp8}


class Routing:
    """The MoE layers' routing decisions, one entry per gate call (steps in
    order, layers in order within a step).

    ``given``: gate logits ``[T, E]`` of another run, whose top ``k`` the
    reference follows; None: it follows its own.  Each call appends its
    own logits to ``seen`` and, where ``given``, to ``gaps`` the widest
    shortfall over the routed tokens of a followed expert's probability
    below the reference's own ``k``-th best."""

    def __init__(self, given: Optional[List[torch.Tensor]] = None):
        self.given = given
        self.seen: List[torch.Tensor] = []
        self.gaps: List[float] = []

    def decide(self, logits: torch.Tensor) -> torch.Tensor:
        n = len(self.seen)
        self.seen.append(logits.detach().float().clone())
        if self.given is None:
            return logits
        if n >= len(self.given):
            raise ValueError(f"gate call {n + 1}: only {len(self.given)} "
                             "routing decisions were given")
        return self.given[n].to(logits.device, torch.float32)


class Reference:
    """One model configuration's reference step (module docstring)."""

    def __init__(self, cfg: Dict, precision: str = "fp32",
                 routing: Optional[Routing] = None):
        if precision not in ROUNDING:
            raise ValueError(f"precision {precision!r}: one of "
                             f"{sorted(ROUNDING)}")
        self.cfg = cfg
        self.precision = precision
        self.H = cfg["hidden_size"]
        self.N = cfg["num_attention_heads"]
        self.D = self.H // self.N
        self.L = cfg["num_hidden_layers"]
        self.E = cfg.get("moe_experts", 0)
        self.k = cfg.get("moe_top_k", 0)
        self.eps = cfg["layer_norm_eps"]
        self.drop = cfg["hidden_dropout_prob"]
        self.routing = routing
        if cfg["attention_probs_dropout_prob"] > 0:
            raise ValueError("the reference draws no attention-probability "
                             "dropout")
        if cfg["hidden_act"] != "gelu":
            raise ValueError("the reference's activation is exact GELU")

    # ------------------------------------------------------------ pieces
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        rnd = ROUNDING[self.precision]
        if rnd is None:
            return a @ b
        return _RoundedMatmul.apply(a, b, rnd)

    def linear(self, x, w, b):
        return self.mm(x, w.t()) + b

    def layer_norm(self, x, scale, bias):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * scale + bias

    @staticmethod
    def gelu(x):
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))

    def dropout(self, x, gen):
        if self.drop <= 0:
            return x
        keep = 1.0 - self.drop
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def attention(self, x, p, seg):
        B, S, H = x.shape
        N, D = self.N, self.D

        def heads(t):
            return t.view(B, S, N, D).transpose(1, 2)        # [B, N, S, D]

        q = heads(self.linear(x, p["q.weight"], p["q.bias"]))
        k = heads(self.linear(x, p["k.weight"], p["k.bias"]))
        v = heads(self.linear(x, p["v.weight"], p["v.bias"]))
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
        bias = torch.where(same, 0.0, -1e9)[:, None]          # [B, 1, S, S]
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(D) + bias
        ctx = self.mm(torch.softmax(scores, -1), v)
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        return self.linear(ctx, p["o.weight"], p["o.bias"])

    def route(self, x2: torch.Tensor, gate: torch.Tensor,
              routed: torch.Tensor):
        """Top-k routing with capacity slots over ``x2`` ``[T, H]``:
        ``(probs, top_idx, weights, kept)``, ``kept`` ``[T * k]``
        token-major; an assignment keeps its slot iff fewer than
        ``C = min(ceil(cf * k * T / E), T)`` routed assignments to its
        expert come before it.  The top ``k`` is ranked by
        :attr:`routing`'s given logits where there are any (ties to the
        lower index), the weights are the own probabilities there."""
        T = x2.shape[0]
        E, k = self.E, self.k
        logits = self.mm(x2, gate)
        probs = torch.softmax(logits, -1)
        rank = probs
        if self.routing is not None:
            rank = torch.softmax(self.routing.decide(logits), -1)
        _p, top_i = torch.sort(rank, dim=-1, descending=True, stable=True)
        top_i = top_i[:, :k]
        top_p = probs.gather(1, top_i)
        if self.routing is not None and self.routing.given is not None:
            with torch.no_grad():
                kth = probs.topk(k, -1).values[:, -1]
                short = (kth - top_p.min(-1).values).clamp_min(0)[routed]
                self.routing.gaps.append(
                    float(short.max()) if short.numel() else 0.0)
        w = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        e = top_i.reshape(-1)
        r = routed.repeat_interleave(k)
        onehot = torch.nn.functional.one_hot(e, E) * r[:, None]
        before = (onehot.cumsum(0) - onehot).gather(1, e[:, None])[:, 0]
        cap = min(math.ceil(self.cfg["moe_capacity_factor"] * k * T / E), T)
        return probs, top_i, w, r & (before < cap)

    def moe(self, x, p, mask):
        B, S, H = x.shape
        x2 = x.reshape(B * S, H)
        routed = mask.reshape(-1) > 0
        probs, top_i, w, kept = self.route(x2, p["gate.kernel"], routed)
        e = top_i.reshape(-1)
        wflat = w.reshape(-1)
        out = torch.zeros_like(x2)
        for j in range(self.E):
            a = torch.nonzero(kept & (e == j))[:, 0]
            t = a // self.k
            h = self.gelu(self.mm(x2[t], p["up.kernel"][j]) + p["up.bias"][j])
            y = self.mm(h, p["down.kernel"][j]) + p["down.bias"][j]
            out = out.index_add(0, t, y * wflat[a][:, None])
        m = routed.to(x.dtype)[:, None]
        top1 = torch.nn.functional.one_hot(top_i[:, 0], self.E).to(x.dtype)
        denom = m.sum().clamp_min(1.0)
        aux = self.E * ((top1 * m).sum(0) / denom
                        * (probs * m).sum(0) / denom).sum()
        return out.view(B, S, H), aux

    # ------------------------------------------------------------- step
    def loss(self, params: Dict[str, torch.Tensor], batch, gen,
             weight_mask: Optional[torch.Tensor] = None):
        """``(loss, objective)`` of one packed batch (device tensors).
        ``weight_mask`` ``[B, M]`` scales the example weights (a test
        fault leaves part of the batch out)."""
        P = params
        ids, seg = batch["input_ids"].long(), batch["segment_ids"].long()
        pos = batch["position_ids"].long()
        tt = batch["token_type_ids"].long()
        mask = batch["attention_mask"]
        x = P["embeddings.word"][ids] + P["embeddings.position"][pos] \
            + P["embeddings.token_type"][tt]
        x = self.layer_norm(x, P["embeddings.ln.scale"],
                            P["embeddings.ln.bias"])
        x = self.dropout(x, gen)
        aux = x.new_zeros(())
        for i in range(self.L):
            p = {n[len(f"layers.{i}."):]: v for n, v in P.items()
                 if n.startswith(f"layers.{i}.")}
            a = self.attention(x, p, seg)
            x = self.layer_norm(x + self.dropout(a, gen), p["attn_ln.scale"],
                                p["attn_ln.bias"])
            if self.E:
                h, a_l = self.moe(x, p, mask)
                aux = aux + a_l
            else:
                h = self.linear(self.gelu(self.linear(x, p["up.weight"],
                                                      p["up.bias"])),
                                p["down.weight"], p["down.bias"])
            x = self.layer_norm(x + self.dropout(h, gen), p["mlp_ln.scale"],
                                p["mlp_ln.bias"])
        cls = batch["cls_positions"].long()
        B, M = cls.shape
        h0 = torch.take_along_dim(x, cls[..., None], dim=1).reshape(B * M, -1)
        pooled = torch.tanh(self.linear(h0, P["pooler.weight"],
                                        P["pooler.bias"]))
        pooled = self.dropout(pooled, gen)
        logits = self.linear(pooled, P["classifier.weight"],
                             P["classifier.bias"])
        y = batch["label"].reshape(-1).long()
        wts = batch["example_weight"].reshape(-1).to(logits.dtype)
        if weight_mask is not None:
            wts = wts * weight_mask.reshape(-1).to(wts.dtype)
        ce = torch.logsumexp(logits, -1) - logits.gather(1, y[:, None])[:, 0]
        loss = (ce * wts).sum() / wts.sum().clamp_min(1.0)
        objective = loss
        if self.E:
            objective = loss + self.cfg["moe_aux_coef"] * aux
        return loss, objective


class AdamW:
    """Decoupled AdamW, eps outside the square root, bias-corrected; the
    decay applies to ``matrix`` parameters only."""

    def __init__(self, shapes, lr: float, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay: float = 0.01):
        self.kind = {n: k for n, (_s, k) in shapes.items()}
        self.lr, self.b1, self.b2 = lr, betas[0], betas[1]
        self.eps, self.wd = eps, weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            m = self.m.setdefault(n, torch.zeros_like(p))
            v = self.v.setdefault(n, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            if self.kind[n] == "matrix":
                p.mul_(1.0 - self.lr * self.wd)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def train_steps(ref: Reference, params: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]], gen, opt: AdamW,
                weight_masks=None) -> List[float]:
    """Run the reference over ``batches`` in order, updating ``params`` in
    place; returns each step's loss."""
    losses = []
    names = list(params)
    for i, b in enumerate(batches):
        leaves = {n: params[n].detach().requires_grad_() for n in names}
        loss, objective = ref.loss(
            leaves, b, gen, None if weight_masks is None else weight_masks[i])
        grads = torch.autograd.grad(objective, [leaves[n] for n in names],
                                    allow_unused=True)
        opt.step(params, {n: (g if g is not None else torch.zeros_like(
            params[n])) for n, g in zip(names, grads)})
        losses.append(float(loss.detach()))
        del leaves, loss, objective, grads
    return losses
