"""L1: an acquired resource can reach a function exit unreleased.

For every acquire event (see the registry in ``lifecycle.model``) the
rule asks the CFG: starting from the statement AFTER the acquire, is
there any path — normal or exception edge — that reaches a function
exit without passing a discharge?  Discharges are release calls on the
same receiver, owner-scoped releases (``release_owner``), stores into
``self``-rooted or parameter-rooted state (ownership transferred to a
ledger the runtime audits), returns of the resource (obligation handed
to the caller), and calls into helpers whose summaries release the
argument — the interprocedural inheritance the T1 lock analysis
established.

This is the static face of ``PageAllocator.leak_check()``: the runtime
audit only sees a leak after a drain actually leaks; L1 names the
acquire line whose exception window makes the leak possible.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from pdnlp_tpu_torch.analysis.cfg import RAISE_EXIT, RETURN_EXIT, _own_walk
from pdnlp_tpu_torch.analysis.core import Finding, ProgramInfo, ProgramRule, register
from pdnlp_tpu_torch.analysis.lifecycle.model import (
    ACQUIRE_REGISTRY, AcquireEvent, FuncInfo, LifecycleModel, expr_text,
    get_lifecycle, mentions, root_name, simple_names, _STORE_METHODS,
)


def _spec_for_kind(kind: str):
    for spec in ACQUIRE_REGISTRY:
        if spec.kind == kind:
            return spec
    return None


def alias_closure(fi: FuncInfo, seed: Set[str]) -> Set[str]:
    """Fixpoint alias set: forward links (target assigned FROM a tracked
    value), reverse links through simple compositions (``pin = shared +
    [src]`` tracks ``shared`` too — same pages), and container links (a
    subscript store of a tracked value into a LOCAL container tracks
    the container, so committing the container commits the pages)."""
    names = set(seed)
    if not names:
        return names
    params = set(fi.param_names())
    grew = True
    while grew:
        grew = False
        for node in ast.walk(fi.fn):
            if not isinstance(node, ast.Assign):
                continue
            tgt_names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
            if mentions(node.value, names):
                for t in tgt_names:
                    if t not in names:
                        names.add(t)
                        grew = True
            if any(t in names for t in tgt_names):
                for n in simple_names(node.value):
                    if n not in names:
                        names.add(n)
                        grew = True
            for t in node.targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    rn = root_name(t)
                    if (rn and rn != "self" and rn not in params
                            and rn not in names
                            and mentions(node.value, names)):
                        names.add(rn)  # local container now carries it
                        grew = True
    return names


class _Discharges:
    """Classifies one statement (header only — nested blocks are their
    own CFG nodes) as discharging one event's obligation."""

    def __init__(self, model: LifecycleModel, fi: FuncInfo,
                 event: AcquireEvent, names: Set[str]):
        self.model = model
        self.fi = fi
        self.event = event
        self.names = names
        self.params = set(fi.param_names())

    def _recv_matches(self, recv: ast.AST) -> bool:
        spec = self.event.spec
        if not spec.recv_types and spec.recv_hint is None:
            return True
        text = expr_text(recv)
        if text and text == self.event.recv_text:
            return True
        return self.model.receiver_kind(
            self.fi.mod, self.fi.owner, self.fi.fn, recv) == spec.kind

    def _call_discharges(self, call: ast.Call) -> bool:
        spec = self.event.spec
        f = call.func
        if isinstance(f, ast.Attribute):
            if f.attr in spec.releasers and self._recv_matches(f.value):
                return True
            # store into self-/param-rooted state via a mutator method
            if f.attr in _STORE_METHODS:
                rn = root_name(f.value)
                if (rn == "self" or rn in self.params) and any(
                        mentions(a, self.names) for a in call.args):
                    return True
        # helper summaries: the callee releases the argument / the kind
        callee = self.model.resolve_callee(self.fi.mod, self.fi.owner,
                                           self.fi.fn, call)
        if callee is not None:
            if spec.kind in callee.releases_kinds:
                return True
            if callee.released_params:
                pnames = callee.param_names()
                for i, a in enumerate(call.args):
                    if i < len(pnames) and pnames[i] in \
                            callee.released_params and \
                            mentions(a, self.names):
                        return True
                for kw in call.keywords:
                    if kw.arg in callee.released_params and \
                            mentions(kw.value, self.names):
                        return True
        return False

    def blocks(self, stmt: ast.AST) -> bool:
        if isinstance(stmt, ast.Return):
            if stmt.value is not None and mentions(stmt.value, self.names):
                return True  # ownership handed to the caller
        if isinstance(stmt, (ast.Assign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    rn = root_name(t)
                    if (rn == "self" or rn in self.params) and \
                            mentions(stmt.value, self.names):
                        return True  # committed into tracked state
        for node in _own_walk(stmt) if isinstance(stmt, ast.stmt) \
                else iter(()):
            if isinstance(node, ast.Call) and self._call_discharges(node):
                return True
        return False


@register
class LeakedAcquire(ProgramRule):
    rule_id = "L1"
    name = "leaked-acquire"
    suite = "lifecycle"
    hint = ("release the resource on every exit (try/finally or a broad "
            "except that releases and re-raises), transfer it into a "
            "tracked ledger, or return it to the caller")

    def check_program(self, prog: ProgramInfo) -> Iterator[Finding]:
        model = get_lifecycle(prog)
        for fi in model.funcs.values():
            yield from self._check_function(model, fi)

    # ------------------------------------------------------------ helpers
    def _inherited_events(self, model: LifecycleModel,
                          fi: FuncInfo) -> List[AcquireEvent]:
        """Call sites of acquire-returning helpers inherit the
        obligation (``pages = self._reserve(...)`` is an acquire)."""
        out: List[AcquireEvent] = []
        for nid, stmt in list(fi.cfg.stmts.items()):
            if not isinstance(stmt, (ast.Assign, ast.Expr)):
                continue
            value = stmt.value
            if not isinstance(value, ast.Call):
                continue
            callee = model.resolve_callee(fi.mod, fi.owner, fi.fn, value)
            if callee is None or callee.returns_kind is None:
                continue
            spec = _spec_for_kind(callee.returns_kind)
            if spec is None:
                continue
            names: Set[str] = set()
            if isinstance(stmt, ast.Assign):
                names = {t.id for t in stmt.targets
                         if isinstance(t, ast.Name)}
            recv = (expr_text(value.func.value)
                    if isinstance(value.func, ast.Attribute) else "")
            out.append(AcquireEvent(spec, value, stmt, names, recv))
        return out

    def _check_function(self, model: LifecycleModel,
                        fi: FuncInfo) -> Iterator[Finding]:
        events = list(model.events_of(fi))
        events += self._inherited_events(model, fi)
        if not events:
            return
        cfg = fi.cfg
        for event in events:
            spec = event.spec
            names = alias_closure(fi, event.names)
            judge = _Discharges(model, fi, event, names)
            blocked = {nid for nid, stmt in cfg.stmts.items()
                       if judge.blocks(stmt)}
            acq_node = cfg.node_of(event.stmt)
            if acq_node is None or acq_node in blocked:
                continue  # acquired-and-committed in one statement
            starts = cfg.step_successors(acq_node)
            exits = cfg.reachable_exits(starts, blocked)
            via_exc = RAISE_EXIT in exits
            via_ret = RETURN_EXIT in exits and not spec.exc_only
            if not (via_exc or via_ret):
                continue
            exit_id = RAISE_EXIT if via_exc else RETURN_EXIT
            path = cfg.path_to_exit(starts, blocked, exit_id)
            esc = cfg.last_line_before(path) if path else None
            how = ("an exception edge" if via_exc else "a return path")
            where = f" (escape at line {esc})" if esc else ""
            meth = (event.call.func.attr
                    if isinstance(event.call.func, ast.Attribute)
                    else expr_text(event.call.func))
            yield self.finding(
                fi.mod, event.call,
                f"{spec.kind} acquired by `{meth}(...)` can reach a "
                f"function exit via {how} without "
                f"release/transfer{where}",
                spec.hint or None)
