"""R5 — a CUDA graph captured without the shared memory pool.

``torch.cuda.graph(g)`` with no ``pool=`` gives the graph a private
memory pool: every buffer its replay writes stays reserved for it alone.
A module that captures more than one graph (one per served shape, one per
K-step group shape) then holds the sum of every graph's transient memory
where one pool, shared through ``pool=`` (``graph.pool()`` of the first,
or ``torch.cuda.graph_pool_handle()``), would hold the largest — the
memory twin of JAX's undonated train step, which keeps two copies of the
state.  The port's two capture sites (``serve.engine`` and
``train.steps._MultiStep``) pass one.

Heuristic: a ``torch.cuda.graph(...)`` call with no ``pool`` keyword, in
a module that holds more than one capture site, or inside a loop, or in a
function that keeps its graphs in a table (a subscript assignment:
``self.graphs[key] = ...``) — all shapes of "more than one graph".
"""
from __future__ import annotations

import ast
from typing import Iterator, List

from pdnlp_tpu_torch.analysis.core import (
    GRAPH_CONTEXTS, Finding, ModuleInfo, Rule, register,
)


@register
class GraphWithoutPool(Rule):
    rule_id = "R5"
    name = "graph-without-shared-pool"
    hint = ("capture every graph of the module into one pool: "
            "torch.cuda.graph(g, pool=self._pool), with self._pool = "
            "g.pool() after the first capture (train.steps._MultiStep)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        sites: List[ast.Call] = [
            n for n in ast.walk(mod.tree) if isinstance(n, ast.Call)
            and mod.resolves_to(n.func, GRAPH_CONTEXTS)]
        for call in sites:
            if any(k.arg == "pool" or k.arg is None for k in call.keywords) \
                    or len(call.args) >= 2:
                continue
            why = self._many(mod, call, len(sites))
            if why:
                yield self.finding(
                    mod, call,
                    f"CUDA graph captured without pool= where {why}: each "
                    "graph keeps a private memory pool")

    @staticmethod
    def _many(mod: ModuleInfo, call: ast.Call, n_sites: int) -> str:
        if n_sites > 1:
            return f"the module captures at {n_sites} sites"
        p = mod.parents.get(call)
        fn = None
        while p is not None:
            if isinstance(p, (ast.For, ast.While)):
                return "the capture runs in a loop"
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fn = p
                break
            p = mod.parents.get(p)
        if fn is not None and any(
                isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Subscript) for t in n.targets)
                for n in ast.walk(fn)):
            return "the function keeps its graphs in a table"
        return ""
