"""Intraprocedural control-flow graphs with exception edges — the
path-sensitivity layer under the lifecycle suite (L1-L4).

The tracing rules (R*) judge single statements; the concurrency rules
(T*) judge the whole thread mesh; the lifecycle rules ask a question
neither can answer: *can this statement's effect reach a function exit
along SOME path without a matching counter-effect?*  That needs a CFG —
including the paths the interpreter takes when a statement raises.

Design (deliberately small — this is a linter, not a compiler):

- **statement granularity**: every ``ast.stmt`` (and every
  ``ast.ExceptHandler``) is one node; basic blocks would only compress
  what reachability walks anyway at this scale.
- **two edge kinds**: ``"step"`` (normal completion) and ``"exc"`` (the
  statement raised).  A statement gets exception edges when it plausibly
  raises: ``raise``/``assert``, or any call not in
  :data:`NO_RAISE_CALLS` (attribute loads, arithmetic and subscript
  stores are treated as non-raising — modelling MemoryError-grade
  failure would drown every rule in noise).
- **synthetic exits**: :data:`RETURN_EXIT` (fell off the end /
  ``return``) and :data:`RAISE_EXIT` (an exception escaped the
  function).  These are the targets lifecycle rules test reachability
  against.
- **try/except**: a raising statement in the body gets an ``exc`` edge
  to EVERY handler, plus an escape edge past the handlers unless one of
  them is broad (bare ``except``, ``Exception``, ``BaseException``) —
  that is exactly how ``except KVPagesExhausted:`` fails to cover an
  ``AssertionError`` between an alloc and its table commit.
- **try/finally**: every way out of the protected region (normal,
  exception, ``return``/``break``/``continue``) routes through the
  ``finally`` body, whose exit then fans out to every continuation the
  region could have taken.  The fan-out over-approximates (a path may
  "return" and then also continue) — safe for must-release analysis,
  where extra paths can only make the rule MORE demanding, and the
  release-in-finally idiom dominates the fan-out either way.
- **with**: the body runs with the same exception context (we assume
  context managers do not swallow exceptions); the acquire-site rules
  treat ``with``-managed resources as released by construction.

Loops keep their back edge, so reachability naturally covers the
leak-on-second-iteration shapes without any special casing.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: synthetic exit reached by ``return`` statements and by falling off
#: the end of the function body
RETURN_EXIT = -1
#: synthetic exit reached when an exception escapes the function
RAISE_EXIT = -2

EXITS = (RETURN_EXIT, RAISE_EXIT)

#: calls assumed not to raise in practice — the containment keeps
#: exception edges meaningful instead of universal.  Matched against the
#: LAST segment of the callee's dotted name, so both ``x.append`` and
#: ``collections.deque.append`` hit.
NO_RAISE_CALLS = frozenset({
    # containers / queues / sets
    "append", "appendleft", "extend", "add", "discard", "update",
    "setdefault", "get", "items", "keys", "values", "copy", "clear",
    # threading signalling (never raises once constructed)
    "notify", "notify_all", "set", "is_set", "release_owner_hint",
    # metrics / tracing (designed to be fail-safe on the hot path)
    "inc", "dec", "observe", "record", "record_hop", "labels",
    # string ops
    "join", "split", "strip", "lstrip", "rstrip", "format", "lower",
    "upper", "startswith", "endswith", "replace_text",
    # clocks
    "monotonic", "perf_counter", "time",
    # benign builtins
    "len", "isinstance", "hasattr", "getattr", "id", "repr", "str",
    "bool", "abs", "min", "max", "sum", "sorted", "range", "enumerate",
    "zip", "print", "callable", "type", "int", "float", "tuple",
    "list", "dict", "frozenset",
})

_BROAD_EXC = {"Exception", "BaseException"}


def stmt_can_raise(stmt: ast.stmt) -> bool:
    """Does executing ``stmt``'s own code (not its nested block bodies)
    plausibly raise?  Drives where ``exc`` edges are drawn."""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    for node in _own_walk(stmt):
        if isinstance(node, ast.Call):
            name = _callee_tail(node)
            if name is None or name not in NO_RAISE_CALLS:
                return True
        elif isinstance(node, (ast.Await, ast.Yield, ast.YieldFrom)):
            return True
    return False


def _callee_tail(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


_BLOCK_FIELDS = ("body", "orelse", "finalbody", "handlers")


def _own_walk(stmt: ast.stmt):
    """Walk ``stmt``'s header expressions only — the nested statement
    blocks (``body``/``orelse``/...) are separate CFG nodes."""
    todo: List[ast.AST] = []
    for field, value in ast.iter_fields(stmt):
        if field in _BLOCK_FIELDS:
            continue
        if isinstance(value, ast.AST):
            todo.append(value)
        elif isinstance(value, list):
            todo += [v for v in value if isinstance(v, ast.AST)]
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue  # nested defs don't run here
        todo += list(ast.iter_child_nodes(node))
    return


class CFG:
    """One function's control-flow graph.  ``stmts`` maps node id ->
    the ``ast.stmt`` / ``ast.ExceptHandler`` it models; ``succ`` maps
    node id -> ``[(successor id, "step"|"exc"), ...]``; ``entry`` is
    the first node (or :data:`RETURN_EXIT` for an empty body)."""

    def __init__(self) -> None:
        self.stmts: Dict[int, ast.AST] = {}
        self.succ: Dict[int, List[Tuple[int, str]]] = {}
        self.entry: int = RETURN_EXIT

    # ------------------------------------------------------------ queries
    def nodes_for(self, stmt: ast.AST) -> List[int]:
        return [nid for nid, s in self.stmts.items() if s is stmt]

    def node_of(self, stmt: ast.AST) -> Optional[int]:
        for nid, s in self.stmts.items():
            if s is stmt:
                return nid
        return None

    def step_successors(self, nid: int) -> List[int]:
        return [t for t, kind in self.succ.get(nid, []) if kind == "step"]

    def reachable_exits(self, starts: Sequence[int],
                        blocked: Set[int]) -> Set[int]:
        """Which synthetic exits are reachable from ``starts`` without
        entering a ``blocked`` node — the core must-release query."""
        seen: Set[int] = set()
        stack = [s for s in starts if s not in blocked]
        exits: Set[int] = set()
        while stack:
            nid = stack.pop()
            if nid in seen:
                continue
            seen.add(nid)
            if nid in EXITS:
                exits.add(nid)
                continue
            for t, _kind in self.succ.get(nid, []):
                if t not in blocked and t not in seen:
                    stack.append(t)
        return exits

    def path_to_exit(self, starts: Sequence[int], blocked: Set[int],
                     exit_id: int) -> Optional[List[int]]:
        """One concrete blocked-avoiding path (list of node ids) from
        ``starts`` to ``exit_id`` — for human-readable findings.  BFS,
        so the reported path is a shortest one."""
        from collections import deque
        prev: Dict[int, int] = {}
        q = deque(s for s in starts if s not in blocked)
        seen = set(q)
        while q:
            nid = q.popleft()
            if nid == exit_id:
                path = [nid]
                while path[-1] in prev:
                    path.append(prev[path[-1]])
                return list(reversed(path))
            if nid in EXITS:
                continue
            for t, _kind in self.succ.get(nid, []):
                if t not in blocked and t not in seen:
                    seen.add(t)
                    prev[t] = nid
                    q.append(t)
        return None

    def last_line_before(self, path: List[int]) -> Optional[int]:
        """Line of the last real statement on ``path`` (the escape
        site a finding names)."""
        for nid in reversed(path):
            stmt = self.stmts.get(nid)
            if stmt is not None and hasattr(stmt, "lineno"):
                return stmt.lineno
        return None


class _Ctx:
    """Continuation targets while building: where an exception goes
    (possibly several handlers), where return/break/continue go."""

    __slots__ = ("exc", "return_to", "break_to", "continue_to")

    def __init__(self, exc: Tuple[int, ...], return_to: int,
                 break_to: Optional[int], continue_to: Optional[int]):
        self.exc = exc
        self.return_to = return_to
        self.break_to = break_to
        self.continue_to = continue_to

    def with_(self, **kw) -> "_Ctx":
        vals = {"exc": self.exc, "return_to": self.return_to,
                "break_to": self.break_to, "continue_to": self.continue_to}
        vals.update(kw)
        return _Ctx(**vals)


class _Builder:
    def __init__(self) -> None:
        self.cfg = CFG()
        self._next = 0

    def _node(self, stmt: ast.AST) -> int:
        nid = self._next
        self._next += 1
        self.cfg.stmts[nid] = stmt
        self.cfg.succ[nid] = []
        return nid

    def _edge(self, src: int, dst: int, kind: str = "step") -> None:
        if (dst, kind) not in self.cfg.succ[src]:
            self.cfg.succ[src].append((dst, kind))

    # --------------------------------------------------------------- build
    def build(self, fn: ast.AST) -> CFG:
        body = list(fn.body) if isinstance(fn.body, list) else [fn.body]
        ctx = _Ctx(exc=(RAISE_EXIT,), return_to=RETURN_EXIT,
                   break_to=None, continue_to=None)
        self.cfg.entry = self._seq(body, RETURN_EXIT, ctx)
        return self.cfg

    def _seq(self, stmts: List[ast.stmt], nxt: int, ctx: _Ctx) -> int:
        entry = nxt
        for stmt in reversed(stmts):
            entry = self._stmt(stmt, entry, ctx)
        return entry

    def _exc_edges(self, nid: int, stmt: ast.stmt, ctx: _Ctx) -> None:
        if stmt_can_raise(stmt):
            for target in ctx.exc:
                self._edge(nid, target, "exc")

    def _stmt(self, stmt: ast.stmt, nxt: int, ctx: _Ctx) -> int:
        nid = self._node(stmt)

        if isinstance(stmt, ast.Return):
            self._edge(nid, ctx.return_to)
            self._exc_edges(nid, stmt, ctx)
        elif isinstance(stmt, ast.Raise):
            for target in ctx.exc:
                self._edge(nid, target, "exc")
        elif isinstance(stmt, ast.Break) and ctx.break_to is not None:
            self._edge(nid, ctx.break_to)
        elif isinstance(stmt, ast.Continue) and ctx.continue_to is not None:
            self._edge(nid, ctx.continue_to)
        elif isinstance(stmt, ast.If):
            body = self._seq(stmt.body, nxt, ctx)
            orelse = self._seq(stmt.orelse, nxt, ctx)
            self._edge(nid, body)
            self._edge(nid, orelse)
            self._exc_edges(nid, stmt, ctx)
        elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            after = self._seq(list(stmt.orelse), nxt, ctx)
            loop_ctx = ctx.with_(break_to=nxt, continue_to=nid)
            body = self._seq(stmt.body, nid, loop_ctx)
            self._edge(nid, body)    # iterate
            self._edge(nid, after)   # loop exits (or test false)
            self._exc_edges(nid, stmt, ctx)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            body = self._seq(stmt.body, nxt, ctx)
            self._edge(nid, body)
            self._exc_edges(nid, stmt, ctx)
        elif isinstance(stmt, ast.Try):
            self._try(nid, stmt, nxt, ctx)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            self._edge(nid, nxt)  # a def is just a binding here
        else:
            self._edge(nid, nxt)
            self._exc_edges(nid, stmt, ctx)
        return nid

    def _try(self, nid: int, stmt: ast.Try, nxt: int, ctx: _Ctx) -> None:
        # ---- finally: everything routes through it, then fans out
        if stmt.finalbody:
            fan = self._node(stmt)  # synthetic fan-out point after finally
            fin_entry = self._seq(stmt.finalbody, fan, ctx)
            for target in {nxt, ctx.return_to, *ctx.exc} | (
                    {ctx.break_to} if ctx.break_to is not None else set()) | (
                    {ctx.continue_to} if ctx.continue_to is not None
                    else set()):
                self._edge(fan, target)
            inner_ctx = ctx.with_(exc=(fin_entry,), return_to=fin_entry,
                                  break_to=fin_entry
                                  if ctx.break_to is not None else None,
                                  continue_to=fin_entry
                                  if ctx.continue_to is not None else None)
            after_body = fin_entry
        else:
            inner_ctx = ctx
            after_body = nxt

        # ---- handlers
        handler_entries: List[int] = []
        broad = False
        for h in stmt.handlers:
            h_node = self._node(h)
            h_body = self._seq(h.body, after_body, inner_ctx)
            self._edge(h_node, h_body)
            handler_entries.append(h_node)
            if h.type is None:
                broad = True
            else:
                names = [h.type] if not isinstance(h.type, ast.Tuple) \
                    else list(h.type.elts)
                for t in names:
                    tail = t.attr if isinstance(t, ast.Attribute) else (
                        t.id if isinstance(t, ast.Name) else None)
                    if tail in _BROAD_EXC:
                        broad = True

        body_exc: Tuple[int, ...] = tuple(handler_entries)
        if not broad:
            body_exc = body_exc + inner_ctx.exc  # escapes past handlers
        if not body_exc:
            body_exc = inner_ctx.exc

        body_ctx = inner_ctx.with_(exc=body_exc)
        orelse_entry = self._seq(list(stmt.orelse), after_body, inner_ctx)
        body_entry = self._seq(stmt.body, orelse_entry, body_ctx)
        self._edge(nid, body_entry)


def build_cfg(fn: ast.AST) -> CFG:
    """CFG for one FunctionDef / AsyncFunctionDef / Lambda body."""
    return _Builder().build(fn)
