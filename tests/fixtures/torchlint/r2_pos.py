"""R2 positive: Python branches on a tensor's value inside captures."""
import torch

POOL = torch.cuda.graph_pool_handle()


def clip(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        if x.sum() > 0:                # line 9: if on a tensor's value
            x = x * 2
    return x


@torch.compile
def shrink(x):
    while x.max() > 1:                 # line 16: while on a tensor's value
        x = x / 2
    return x


def checked(graph, loss):
    with torch.cuda.graph(graph, pool=POOL):
        assert loss < 1e3              # line 23: assert on a tensor
    return loss


def step(state, batch):
    y = batch["x"] * 2
    if y.any():                        # line 29: if on a tensor's value
        y = y + 1
    return y


def run(state, batch):
    return build_multi_step(step, "cuda")(state, batch)   # noqa: F821
