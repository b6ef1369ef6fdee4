"""R1 negative: host reads outside captures, metadata reads inside."""
import torch

POOL = torch.cuda.graph_pool_handle()


def after_replay(graph, x, out):
    with torch.cuda.graph(graph, pool=POOL):
        out.copy_(x * 2)
        n = x.size(0) + x.shape[1] + x.numel()
    graph.replay()
    torch.cuda.synchronize()
    return float(out.sum()), out.item(), out.cpu(), n


def copies_to_pinned(graph, x, pinned):
    with torch.cuda.graph(graph, pool=POOL):
        y = x.to("cuda")
        pinned.copy_(y, non_blocking=True)
        z = x.to("cpu", non_blocking=True)
    return z


def eager_step(x):
    return x.item()
