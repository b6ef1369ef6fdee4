"""R2 negative: branches on host metadata and host state."""
import torch

POOL = torch.cuda.graph_pool_handle()


def pad(graph, x, mask=None, training=True):
    with torch.cuda.graph(graph, pool=POOL):
        if x.shape[0] > 8 and x.dim() == 2 and x.size(1) > 4:
            x = x[:8]
        if mask is not None:
            x = x * mask
        if len(x) and "k" in {"k": 1}:
            x = x + 1
        assert x.dtype == torch.float32
    return x


def eager(x):
    if x.sum() > 0:
        return x
    return -x
