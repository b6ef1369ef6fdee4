"""R1 positive: host syncs inside captured code (never executed, AST only)."""
import numpy as np
import torch

POOL = torch.cuda.graph_pool_handle()


def loss_value(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        return float(x.sum())          # line 10: float() on a tensor


def to_numpy(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        return np.asarray(x) * 2.0     # line 15: np.asarray in a capture


def waits(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        torch.cuda.synchronize()       # line 20: synchronize in a capture
        return x


@torch.compile
def item_call(x):
    return x.item()                    # line 26: .item() in compiled code


def step(x):
    return x.to("cpu")                 # line 30: blocking copy to the host


def run(x):
    multi = build_multi_step(step, "cuda")   # noqa: F821
    return multi(x)
