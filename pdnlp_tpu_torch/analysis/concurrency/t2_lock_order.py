"""T2 — lock-order cycles (potential deadlock).

Build the acquired-while-holding graph over every lock the program owns
(class locks by qualified name, module-level locks by file): an edge
``A -> B`` means some code path acquires ``B`` while already holding
``A`` — from a lexically nested ``with``, or interprocedurally: a call
made under ``A`` to a function/method that (transitively) acquires ``B``.
A cycle in that graph is a deadlock waiting for the right interleaving:
thread 1 parks inside ``A`` waiting for ``B`` exactly as thread 2 parks
inside ``B`` waiting for ``A``.

One finding per cycle, placed on an acquisition site of the first edge,
with EVERY edge's two sites cited (where the outer lock was held, where
the inner was acquired) so the fix — pick one global order, or drop work
out of the outer region — can be made with the whole loop in view.

Re-acquiring the SAME lock is not an edge (RLock re-entry is legal, and a
plain-Lock self-deadlock is a different bug class T3's unbounded-wait
checks approximate).
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, ProgramInfo, ProgramRule, register,
)
from pdnlp_tpu_torch.analysis.concurrency.model import (
    ConcurrencyModel, FuncKey, LockToken, get_model, token_display,
)

#: interprocedural acquisition summaries stop here — deeper chains exist
#: but three hops covers every idiom this repo has grown
_MAX_DEPTH = 4


class _Edge:
    __slots__ = ("a", "b", "mod", "site_a", "site_b", "via")

    def __init__(self, a: LockToken, b: LockToken, mod: ModuleInfo,
                 site_a: ast.AST, site_b: ast.AST, via: str):
        self.a, self.b = a, b
        self.mod = mod
        self.site_a = site_a      # where A was held (its acquisition)
        self.site_b = site_b      # where B is acquired (or the call site)
        self.via = via            # "" or "via <callee>"

    def cite(self) -> str:
        held = f"{self.mod.path}:{getattr(self.site_a, 'lineno', '?')}"
        acq = f"{self.mod.path}:{getattr(self.site_b, 'lineno', '?')}"
        via = f" {self.via}" if self.via else ""
        return (f"holding {token_display(self.a)} (acquired {held}) "
                f"acquires {token_display(self.b)} ({acq}{via})")


@register
class LockOrderCycle(ProgramRule):
    rule_id = "T2"
    name = "lock-order-cycle"
    suite = "concurrency"
    hint = ("pick ONE global acquisition order for the locks in the cycle "
            "and restructure the minority path to follow it (usually: "
            "snapshot what you need under the first lock, release, then "
            "take the second)")

    def check_program(self, prog: ProgramInfo) -> Iterator[Finding]:
        model = get_model(prog)
        edges: Dict[Tuple[LockToken, LockToken], _Edge] = {}
        acq_memo: Dict[FuncKey, Set[Tuple[LockToken, str, int]]] = {}

        for key, facts in model.facts.items():
            for acq in facts.acquires:
                for a, site_a in acq.held_before:
                    if a != acq.token:
                        edges.setdefault((a, acq.token), _Edge(
                            a, acq.token, facts.mod, site_a, acq.node, ""))
            for c in facts.calls:
                if not c.held or c.callee is None \
                        or c.callee not in model.facts:
                    continue
                for b, where in self._acquired_by(model, c.callee,
                                                  acq_memo, _MAX_DEPTH):
                    for a, site_a in c.held:
                        if a != b:
                            edges.setdefault((a, b), _Edge(
                                a, b, facts.mod, site_a, c.node,
                                f"via {self._callee_name(c.callee)} "
                                f"at {where}"))

        adj: Dict[LockToken, Set[LockToken]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        seen_cycles: Set[frozenset] = set()
        for cycle in self._cycles(adj):
            key = frozenset(cycle)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            cycle_edges = [edges[(cycle[i], cycle[(i + 1) % len(cycle)])]
                           for i in range(len(cycle))]
            first = cycle_edges[0]
            order = " -> ".join(token_display(t) for t in cycle
                                ) + f" -> {token_display(cycle[0])}"
            yield self.finding(
                first.mod, first.site_b,
                f"lock-order cycle {order} — potential deadlock: "
                + "; ".join(e.cite() for e in cycle_edges))

    # ----------------------------------------------------------- summaries
    def _acquired_by(self, model: ConcurrencyModel, key: FuncKey,
                     memo: Dict, depth: int
                     ) -> Set[Tuple[LockToken, str]]:
        """Locks ``key`` (transitively) acquires, each with a ``file:line``
        of the acquisition for the citation."""
        if key in memo:
            return memo[key]
        memo[key] = set()  # cycle guard
        if depth <= 0:
            return memo[key]
        facts = model.facts.get(key)
        if facts is None:
            return memo[key]
        out: Set[Tuple[LockToken, str]] = set()
        for acq in facts.acquires:
            out.add((acq.token,
                     f"{facts.mod.path}:"
                     f"{getattr(acq.node, 'lineno', '?')}"))
        for c in facts.calls:
            if c.callee is not None and c.callee in model.facts:
                out |= self._acquired_by(model, c.callee, memo, depth - 1)
        memo[key] = out
        return out

    @staticmethod
    def _callee_name(key: FuncKey) -> str:
        return key.split(":", 1)[1].split(".")[-1] + "()"

    # --------------------------------------------------------------- cycles
    @staticmethod
    def _cycles(adj: Dict[LockToken, Set[LockToken]]
                ) -> List[List[LockToken]]:
        """One simple cycle per strongly connected component of size >= 2
        (enumerating every rotation/ordering would re-report the same
        deadlock shape)."""
        index: Dict[LockToken, int] = {}
        low: Dict[LockToken, int] = {}
        on_stack: Set[LockToken] = set()
        stack: List[LockToken] = []
        sccs: List[List[LockToken]] = []
        counter = [0]

        def strongconnect(v: LockToken) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in sorted(adj.get(v, ()), key=str):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) >= 2:
                    sccs.append(comp)

        for v in sorted(adj, key=str):
            if v not in index:
                strongconnect(v)

        cycles: List[List[LockToken]] = []
        for comp in sccs:
            comp_set = set(comp)
            start = sorted(comp, key=str)[0]
            # DFS inside the SCC for one path start -> ... -> start
            path: List[LockToken] = [start]
            found: List[Optional[List[LockToken]]] = [None]

            def dfs(v: LockToken) -> None:
                if found[0] is not None:
                    return
                for w in sorted(adj.get(v, ()), key=str):
                    if w == start and len(path) >= 2:
                        found[0] = list(path)
                        return
                    if w in comp_set and w not in path:
                        path.append(w)
                        dfs(w)
                        path.pop()

            dfs(start)
            if found[0] is not None:
                cycles.append(found[0])
        return cycles
