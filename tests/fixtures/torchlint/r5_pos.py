"""R5 positive: graphs captured without the shared pool where a module
captures more than one."""
import torch


class Engine:
    def __init__(self):
        self.graphs = {}

    def capture(self, fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):                      # line 12: no pool=
            y = fn(x)
        self.graphs[tuple(x.shape)] = (g, y)


def capture_all(fns, x):
    out = []
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=None):         # line 21: no pool=
            out.append(fn(x))
    return out
