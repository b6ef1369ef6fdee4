"""R3 negative: explicit generators, dropout off, graph-safe swaps, and
host state handled outside the capture."""
import torch
import torch.nn.functional as F
from torch import nn

POOL = torch.cuda.graph_pool_handle()


def noise(x, gen):
    return x + torch.randn(x.shape, generator=gen)


def init(w, gen):
    nn.init.normal_(w, std=0.02, generator=gen)
    w.uniform_(-1, 1, generator=gen)


def eval_forward(x):
    return F.dropout(x, 0.1, training=False)


def replay_masks(graph, gen, state, x):
    saved = gen.get_state()
    graph.register_generator_state(state)
    with torch.cuda.graph(graph, pool=POOL):
        now = gen.graphsafe_get_state()
        gen.graphsafe_set_state(state)
        y = torch.rand(x.shape, generator=gen)
        gen.graphsafe_set_state(now)
    gen.set_state(saved)
    return y
