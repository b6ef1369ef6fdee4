"""R5 negative: one capture site, not in a loop, no table of graphs."""
import torch


def capture_once(fn, x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = fn(x)
    return g, y
