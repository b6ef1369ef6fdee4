"""Device time of one entry of the program at the cell's own shapes: the
attention entry, the MoE layer and its expert products.  Each call is
captured once as a CUDA graph and timed by CUDA events over back-to-back
replays, so the host's launch cost (autograd's above all) does not pace
what is timed, as it would with the calls made from the host.  Each
measurement is made once per run and shared by the metrics that read it
(``ctx.cache``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch


def event_seconds(fn: Callable[[], None], iters: int = 20,
                  warmup: int = 3) -> float:
    """Mean device seconds per call of ``fn`` over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def graph_seconds(fn: Callable[[], None], iters: int = 20) -> float:
    """Mean device seconds of one replay of ``fn`` captured as a CUDA
    graph (warmed up on a side stream first, as capture requires)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    seconds = event_seconds(graph.replay, iters)
    del graph
    return seconds


def _cached(ctx, key: str, make):
    if key not in ctx.cache:
        ctx.cache[key] = make() if ctx.on_card else None
    return ctx.cache[key]


def attention(ctx) -> Optional[Dict[str, float]]:
    """``{"fwd_s", "bwd_s"}``: the port's attention entry (``ops.attention.
    dot_product_attention``, routed as the cell routes it) on the sample
    step's segment ids, at the model's heads and the compute dtype;
    backward = forward and backward less forward."""
    def make():
        from pdnlp_tpu_torch.ops.attention import dot_product_attention

        seg = ctx.sample["segment_ids"]
        B, S = seg.shape
        N, D = ctx.heads, ctx.head_dim
        g = torch.Generator(device=seg.device).manual_seed(1)
        q, k, v, do = (torch.randn(B, S, N, D, generator=g,
                                   device=seg.device, dtype=ctx.dtype)
                       for _ in range(4))
        for t in (q, k, v):
            t.requires_grad_()
        impl = ctx.attn_impl_arg

        def fwd_train():
            return dot_product_attention(q, k, v, None, impl=impl,
                                         segment_ids=seg)

        def both():
            o = fwd_train()
            torch.autograd.grad(o, (q, k, v), do)

        t_fwd = graph_seconds(fwd_train)
        t_both = graph_seconds(both)
        return {"fwd_s": t_fwd, "bwd_s": max(t_both - t_fwd, 0.0)}
    return _cached(ctx, "attention", make)


def moe(ctx) -> Optional[Dict]:
    """The port's MoE layers (``models.bert.moe_mlp``), forward and
    backward, each on its own input of the sample step (the gate inputs of
    one deterministic forward of the model at its trained weights), summed
    over the layers (``layers_s``); each layer's routing of that input, as
    kept assignments per expert (``kept``); the expert products alone
    (``_experts`` up, GELU, down), forward and backward, at the slot
    buffers' shape (``experts_s``)."""
    def make():
        import math

        from pdnlp_tpu_torch.models.bert import _experts, _gelu, moe_mlp

        from gpubench.reference.model import Reference

        model, batch = ctx.model, ctx.sample
        cfg = model.cfg
        B, S = batch["input_ids"].shape
        H, E = cfg.hidden_size, cfg.moe_experts
        dev = batch["input_ids"].device
        mask = batch["attention_mask"]
        inputs = []
        hooks = [lyr.gate.register_forward_pre_hook(
            lambda _m, a: inputs.append(a[0].detach().clone()))
            for lyr in model.layers]
        try:
            with torch.no_grad():
                model.classify(batch, dtype=ctx.dtype,
                               attn_impl=ctx.attn_impl_arg)
        finally:
            for h in hooks:
                h.remove()
        g = torch.Generator(device=dev).manual_seed(2)
        dy = torch.randn(B, S, H, generator=g, device=dev, dtype=ctx.dtype)
        layers_s = 0.0
        for layer, xin in zip(model.layers, inputs):
            x = xin.to(ctx.dtype).requires_grad_()
            wrt = [x] + [p for n, p in layer.named_parameters()
                         if n.startswith(("gate.", "up.", "down."))]

            def layer_step():
                out, aux = moe_mlp(x, layer, cfg, mask)
                torch.autograd.grad((out, aux), wrt,
                                    (dy, torch.ones_like(aux)))

            layers_s += graph_seconds(layer_step, iters=10)

        ref = Reference(ctx.config)
        routed = mask.reshape(-1) > 0
        kept = []
        for lyr, xin in zip(model.layers, inputs):
            with torch.no_grad():
                _p, top_i, _w, k = ref.route(
                    xin.float().reshape(-1, H), lyr.gate.kernel.float(),
                    routed)
            e = top_i.reshape(-1)[k]
            kept.append(torch.bincount(e, minlength=E).tolist())
        T = B * S
        W = min(math.ceil(cfg.moe_capacity_factor * cfg.moe_top_k * T / E),
                T)
        layer = model.layers[0]
        xe = torch.randn(E, W, H, generator=g, device=dev, dtype=ctx.dtype)
        xe.requires_grad_()
        dye = torch.randn(E, W, H, generator=g, device=dev, dtype=ctx.dtype)

        wrt_e = [xe] + list(layer.up.parameters()) \
            + list(layer.down.parameters())

        def products():
            y = _experts(_gelu(_experts(xe, layer.up), cfg.gelu), layer.down)
            torch.autograd.grad(y, wrt_e, dye)

        experts_s = graph_seconds(products, iters=10)
        return {"layers_s": layers_s, "kept": kept, "experts_s": experts_s,
                "slots": W}
    return _cached(ctx, "moe", make)
