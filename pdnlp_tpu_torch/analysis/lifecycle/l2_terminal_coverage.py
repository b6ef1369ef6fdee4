"""L2: hop-chain terminal coverage, statically.

``obs.request.validate_chains`` audits request hop chains at runtime:
every admitted request must record exactly one terminal hop.  It only
sees traffic that ran.  L2 checks the two shapes that produce invalid
chains at the source:

- **orphaned admit**: a function records an ``admit`` hop and can then
  escape on an exception edge with no terminal hop for the same request
  — the caller sees a raise, the chain stays open forever.  (A normal
  return after ``admit`` is the architecture working: the worker thread
  owns the terminal.)
- **double terminal**: two distinct terminal ``record_hop`` sites for
  the same request id where one is reachable from the other.  Terminals
  guarded by the first-wins ``stream._finish(...)`` idiom are exempt —
  that guard is exactly how the runtime enforces at-most-once.

Request identity is matched by the rid argument's expression text
(``stream.rid`` vs ``s.rid`` are different requests), which keeps the
rule honest inside loops over other streams.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from pdnlp_tpu_torch.analysis.cfg import CFG, RAISE_EXIT, build_cfg
from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register
from pdnlp_tpu_torch.analysis.lifecycle.model import expr_text

#: keep in sync with ``pdnlp_tpu_torch.obs.request.TERMINAL_HOPS`` — the
#: analyzer never imports the modules it scans, so the contract is
#: duplicated here and pinned equal by a test.
TERMINAL_HOPS = ("complete", "deadline", "shed", "rejected", "failed")


class _Hop:
    __slots__ = ("call", "stmt", "hop", "rid", "guarded")

    def __init__(self, call: ast.Call, stmt: ast.stmt, hop: str,
                 rid: str, guarded: bool):
        self.call = call
        self.stmt = stmt
        self.hop = hop
        self.rid = rid
        self.guarded = guarded


def _hop_of(call: ast.Call) -> Optional[Tuple[str, ast.AST]]:
    """(hop name, rid expr) when this is ``record_hop(tracer, rid,
    "<constant>", ...)``; variable hop names are out of scope."""
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    if name != "record_hop" or len(call.args) < 3:
        return None
    hop = call.args[2]
    if not (isinstance(hop, ast.Constant) and isinstance(hop.value, str)):
        return None
    return hop.value, call.args[1]


#: the first-wins completion guards: ``DecodeStream._finish`` and the
#: batcher/fleet request's ``_complete`` both return True exactly once
_FIRST_WINS_GUARDS = ("_finish", "_complete")


def _finish_guarded(mod: ModuleInfo, node: ast.AST, fn: ast.AST) -> bool:
    """Is ``node`` under an ``if X._finish(...):`` /
    ``if X._complete(...):`` first-wins guard?"""
    p = mod.parents.get(node)
    while p is not None and p is not fn:
        if isinstance(p, ast.If):
            for n in ast.walk(p.test):
                if isinstance(n, ast.Call) and isinstance(
                        n.func, ast.Attribute) \
                        and n.func.attr in _FIRST_WINS_GUARDS:
                    return True
        p = mod.parents.get(p)
    return False


@register
class TerminalCoverage(Rule):
    rule_id = "L2"
    name = "terminal-coverage"
    suite = "lifecycle"
    hint = ("an admitted request must reach exactly one terminal hop "
            "(complete/deadline/shed/rejected/failed): record a terminal "
            "before re-raising, and guard terminals with the first-wins "
            "stream._finish(...) idiom")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if "record_hop" not in mod.source:
            return
        for name, fn, body in mod.scopes():
            if name == "<module>" or isinstance(fn, ast.Lambda):
                continue
            yield from self._check_function(mod, fn)

    def _check_function(self, mod: ModuleInfo,
                        fn: ast.AST) -> Iterator[Finding]:
        nested = {n for n in ast.walk(fn)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)) and n is not fn}

        def in_nested(node: ast.AST) -> bool:
            p = mod.parents.get(node)
            while p is not None and p is not fn:
                if p in nested:
                    return True
                p = mod.parents.get(p)
            return False

        hops: List[_Hop] = []
        cfg: Optional[CFG] = None
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or in_nested(node):
                continue
            parsed = _hop_of(node)
            if parsed is None:
                continue
            if cfg is None:
                cfg = build_cfg(fn)
            hop_name, rid_expr = parsed
            stmt = self._nearest_stmt(mod, node, cfg)
            if stmt is None:
                continue
            hops.append(_Hop(node, stmt, hop_name, expr_text(rid_expr),
                             _finish_guarded(mod, node, fn)))
        if cfg is None:
            return

        terminals = [h for h in hops if h.hop in TERMINAL_HOPS]

        # ---- orphaned admit: exception escape with no terminal
        for h in hops:
            if h.hop != "admit":
                continue
            blocked = {cfg.node_of(t.stmt) for t in terminals
                       if t.rid == h.rid}
            blocked.discard(None)
            nid = cfg.node_of(h.stmt)
            if nid is None:
                continue
            starts = cfg.step_successors(nid)
            if RAISE_EXIT in cfg.reachable_exits(starts, blocked):
                path = cfg.path_to_exit(starts, blocked, RAISE_EXIT)
                esc = cfg.last_line_before(path) if path else None
                where = f" (escape at line {esc})" if esc else ""
                yield self.finding(
                    mod, h.call,
                    f"request {h.rid!r} is admitted here but an exception "
                    f"path can escape with no terminal hop{where}")

        # ---- double terminal: one unguarded terminal reaches another
        seen_pairs = set()
        unguarded = [t for t in terminals if not t.guarded]
        for t1 in unguarded:
            n1 = cfg.node_of(t1.stmt)
            if n1 is None:
                continue
            starts = cfg.step_successors(n1)
            for t2 in unguarded:
                if t2 is t1 or t2.rid != t1.rid:
                    continue
                n2 = cfg.node_of(t2.stmt)
                if n2 is None:
                    continue
                key = frozenset((n1, n2))
                if key in seen_pairs:
                    continue
                if self._reaches(cfg, starts, n2):
                    seen_pairs.add(key)
                    yield self.finding(
                        mod, t2.call,
                        f"request {t2.rid!r} can record a second terminal "
                        f"hop {t2.hop!r} here (first terminal "
                        f"{t1.hop!r} at line {t1.call.lineno}); guard "
                        "terminals with the first-wins _finish() idiom")

    @staticmethod
    def _nearest_stmt(mod: ModuleInfo, node: ast.AST,
                      cfg: CFG) -> Optional[ast.AST]:
        p = node
        while p is not None:
            if isinstance(p, ast.stmt) and cfg.node_of(p) is not None:
                return p
            p = mod.parents.get(p)
        return None

    @staticmethod
    def _reaches(cfg: CFG, starts, target: int) -> bool:
        seen = set()
        stack = list(starts)
        while stack:
            nid = stack.pop()
            if nid == target:
                return True
            if nid in seen or nid in (RAISE_EXIT,):
                continue
            seen.add(nid)
            stack += [t for t, _k in cfg.succ.get(nid, [])]
        return False
