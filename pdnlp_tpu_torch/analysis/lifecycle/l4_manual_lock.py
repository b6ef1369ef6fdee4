"""L4: a manual ``.acquire()`` must be released on every path.

The repo's locking idiom is ``with self._lock:`` — balanced by
construction, and what the concurrency suite (T1-T3) reasons about.
Manual ``.acquire()``/``.release()`` pairs re-introduce the exact class
of bug ``with`` exists to kill: an early ``return`` or an exception
between the pair leaves the lock held forever and the next acquirer
deadlocked.  L4 flags a manual acquire when ANY path — normal or
exception edge — reaches a function exit without the matching
``.release()`` on the same receiver.

Receivers are classified by the lifecycle model (constructor scan,
whole-program attribute types, then the ``lock``/``mutex``/``cond``
name hint), so bare helper parameters still match.  Conditional
acquires (``if lock.acquire(timeout=...):``) are out of scope — the
result-dependent release needs value tracking, and the repo has no
business writing that shape either.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from pdnlp_tpu_torch.analysis.cfg import RAISE_EXIT, RETURN_EXIT, _own_walk
from pdnlp_tpu_torch.analysis.core import Finding, ProgramInfo, ProgramRule, register
from pdnlp_tpu_torch.analysis.lifecycle.model import (
    FuncInfo, LifecycleModel, expr_text, get_lifecycle,
)


@register
class UnbalancedManualLock(ProgramRule):
    rule_id = "L4"
    name = "unbalanced-manual-lock"
    suite = "lifecycle"
    hint = ("use `with lock:` (balanced by construction), or release in "
            "a finally: block so exception edges unlock too")

    def check_program(self, prog: ProgramInfo) -> Iterator[Finding]:
        model = get_lifecycle(prog)
        for fi in model.funcs.values():
            if ".acquire(" not in fi.mod.source:
                continue
            yield from self._check_function(model, fi)

    def _check_function(self, model: LifecycleModel,
                        fi: FuncInfo) -> Iterator[Finding]:
        mod, fn = fi.mod, fi.fn
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

        acquires = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                    and not in_nested(node)
                    and model.receiver_kind(mod, fi.owner, fn,
                                            node.func.value) == "lock"):
                acquires.append(node)
        if not acquires:
            return

        cfg = fi.cfg
        for call in acquires:
            stmt = self._nearest_stmt(mod, call, cfg)
            if stmt is None:
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                continue  # context-managed
            if isinstance(stmt, (ast.If, ast.While)) and any(
                    call in ast.walk(t) for t in [stmt.test]):
                continue  # conditional acquire: out of scope
            recv = expr_text(call.func.value)
            released: Set[int] = set()
            for nid, s in cfg.stmts.items():
                if not isinstance(s, ast.stmt):
                    continue
                for n in _own_walk(s):
                    if (isinstance(n, ast.Call)
                            and isinstance(n.func, ast.Attribute)
                            and n.func.attr == "release"
                            and expr_text(n.func.value) == recv):
                        released.add(nid)
                        break
            nid = cfg.node_of(stmt)
            if nid is None:
                continue
            starts = cfg.step_successors(nid)
            exits = cfg.reachable_exits(starts, released)
            if not exits:
                continue
            via = ("an exception edge" if RAISE_EXIT in exits
                   else "a return path")
            path = cfg.path_to_exit(
                starts, released,
                RAISE_EXIT if RAISE_EXIT in exits else RETURN_EXIT)
            esc = cfg.last_line_before(path) if path else None
            where = f" (escape at line {esc})" if esc else ""
            yield self.finding(
                mod, call,
                f"manual `{recv}.acquire()` can reach a function exit "
                f"via {via} without `.release()`{where}")

    @staticmethod
    def _nearest_stmt(mod, node, cfg):
        p = node
        while p is not None:
            if isinstance(p, ast.stmt) and cfg.node_of(p) is not None:
                return p
            p = mod.parents.get(p)
        return None
