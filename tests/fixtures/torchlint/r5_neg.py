"""R5 negative: the shared pool, or one graph in the module."""
import torch


class Engine:
    def __init__(self):
        self.graphs = {}
        self._pool = None

    def capture(self, fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._pool):
            y = fn(x)
        if self._pool is None:
            self._pool = g.pool()
        self.graphs[tuple(x.shape)] = (g, y)
