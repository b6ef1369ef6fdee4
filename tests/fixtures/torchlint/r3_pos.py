"""R3 positive: draws from the default generator, and a generator's
state read on the host inside a capture."""
import torch
import torch.nn.functional as F
from torch import nn

POOL = torch.cuda.graph_pool_handle()


def noise(x):
    return x + torch.randn(x.shape)                # line 11: no generator=


def init(w):
    nn.init.normal_(w, std=0.02)                   # line 15: init draw
    w.uniform_(-1, 1)                              # line 16: in-place draw


def drop(x):
    return F.dropout(x, 0.1)                       # line 20: dropout draws


def reseed(graph, gen, x):
    with torch.cuda.graph(graph, pool=POOL):
        gen.manual_seed(0)                         # line 25: host write
        return torch.rand(x.shape, generator=gen)
