"""R3 positive: the port's remat before the recompute became graph-safe
(``models.bert._remat`` as it was), reached from a captured train step:
the recompute saves and restores the dropout generator's state on the
host, which no replay repeats."""
import torch
from torch.utils.checkpoint import checkpoint

POOL = torch.cuda.graph_pool_handle()


def _remat(layer, x, *args, generator, **kw):
    saved = generator.get_state() if generator is not None else None  # line 12:
    weights = dict(layer.named_parameters())
    ran = []

    def body(x):
        if not ran:                       # the forward itself
            ran.append(True)
            return layer(x, *args, generator=generator, **kw)
        now = None                        # the recompute: replay the masks
        if saved is not None:
            now = generator.get_state()                  # line 22:
            generator.set_state(saved)                   # line 23:
        try:
            return torch.func.functional_call(
                layer, weights, (x, *args), {"generator": generator, **kw})
        finally:
            if now is not None:
                generator.set_state(now)                 # line 29:

    return checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)


def encode(layers, x, generator):
    for layer in layers:
        x = _remat(layer, x, generator=generator)
    return x


def capture(graph, layers, x, generator):
    with torch.cuda.graph(graph, pool=POOL):
        loss = encode(layers, x, generator).sum()
        loss.backward()
