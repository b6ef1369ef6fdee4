"""threadlint shared machinery — locks, held-sets, call facts, threads.

Everything the three concurrency analyses (T1/T2/T3) share lives here,
computed ONCE per program:

- **lock discovery** per class (``self._lock = threading.Lock()``) with
  Condition aliasing (``self._wake = threading.Condition(self._lock)``
  guards the same lock — ``with self._wake`` IS ``with self._lock``) and
  module-level locks (``_COMPLETE_LOCK = threading.Lock()``);
- **function facts**: a structural walk of every function body tracking
  the set of locks held at each point — every ``self.<attr>`` access,
  every call site (resolved to a method / module function through the
  program's class-attribute type models), every lock acquisition, and
  every ``threading.Thread(target=...)`` spawn, each stamped with the
  held-set at that point;
- **thread reachability**: the closure of the program call graph from
  spawned-thread entry points (``Thread(target=...)``, ``Timer``,
  ``Thread`` subclass ``run``) — the worker/monitor/harvester entry
  points of the serving stack seed this by construction;
- **must-hold entries** per class: a helper method called only under the
  lock (``_finish_locked`` and friends) inherits that context, so its
  body accesses count as guarded interprocedurally.

Pure ``ast`` like the rest of torchlint: nothing here imports threading's
runtime — the names are matched through each module's import-alias map.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from pdnlp_tpu_torch.analysis.core import ClassModel, ModuleInfo, ProgramInfo

#: a lock identity: ("C", class_qualname, group) for a class-owned lock
#: (group = the canonical attribute name after Condition aliasing) or
#: ("M", module_path, name) for a module-level lock
LockToken = Tuple[str, str, str]

_LOCK_CTORS = {"threading.Lock", "threading.RLock"}
_COND_CTOR = "threading.Condition"

#: thread-entry idioms: a callable handed to one of these runs on its own
#: thread (first arg position / keyword per ctor)
_THREAD_CTORS = {"threading.Thread": "target", "threading.Timer": "function"}


def token_display(tok: LockToken) -> str:
    kind, scope, name = tok
    if kind == "C":
        return f"{scope.split('.')[-1]}.{name}"
    return name


@dataclasses.dataclass(frozen=True)
class Access:
    """One ``self.<attr>`` touch, with the locks held around it."""
    attr: str
    write: bool
    node: ast.AST
    held: FrozenSet[LockToken]


@dataclasses.dataclass(frozen=True)
class CallFact:
    """One call site: resolved callee (or None), receiver type (for the
    ``.get()``/``.join()``/``.wait()`` judgements), the receiver's lock
    token when it IS a lock/condition attribute (the ``cond.wait()``
    exemption), and the held-set with the acquisition node per token (so
    findings can cite WHERE the lock was taken)."""
    node: ast.Call
    callee: Optional[str]              # function-key, see FunctionFacts
    recv_type: Optional[str]           # qualified type of `x` in x.m(...)
    recv_token: Optional[LockToken]    # set when `x` is a known lock/cond
    held: Tuple[Tuple[LockToken, ast.AST], ...]

    def held_tokens(self) -> FrozenSet[LockToken]:
        return frozenset(t for t, _ in self.held)


@dataclasses.dataclass(frozen=True)
class Acquire:
    """One ``with <lock>`` acquisition and what was already held."""
    token: LockToken
    node: ast.AST
    held_before: Tuple[Tuple[LockToken, ast.AST], ...]


#: function key: "m:<class_qualname>.<method>" | "f:<func_qualname>"
FuncKey = str


def method_key(cls_qual: str, name: str) -> FuncKey:
    return f"m:{cls_qual}.{name}"


class FunctionFacts:
    def __init__(self, key: FuncKey, mod: ModuleInfo, fn: ast.AST,
                 owner: Optional[ClassModel]):
        self.key = key
        self.mod = mod
        self.fn = fn
        self.owner = owner
        self.accesses: List[Access] = []
        self.calls: List[CallFact] = []
        self.acquires: List[Acquire] = []
        self.spawn_targets: List[FuncKey] = []


def get_model(prog: ProgramInfo) -> "ConcurrencyModel":
    """The (cached) :class:`ConcurrencyModel` for one program — T1/T2/T3
    share one build per lint run.  Cached ON the program object so the
    model's lifetime is exactly the program's (a global map keyed on
    programs would pin every scanned AST for process lifetime)."""
    model = getattr(prog, "_concurrency_model", None)
    if model is None:
        model = ConcurrencyModel(prog)
        prog._concurrency_model = model
    return model


class ConcurrencyModel:
    """All shared facts for one program (built once, used by T1/T2/T3)."""

    def __init__(self, prog: ProgramInfo):
        self.prog = prog
        #: class qualname -> {lock attr -> group}; Conditions alias their
        #: wrapped lock's group
        self.class_locks: Dict[str, Dict[str, str]] = {}
        #: module path -> module-level lock names
        self.module_locks: Dict[str, Set[str]] = {}
        self.facts: Dict[FuncKey, FunctionFacts] = {}
        self.thread_entries: Set[FuncKey] = set()
        self._discover_locks()
        self._build_facts()
        self.thread_reachable = self._reach_closure()
        self._entry_held: Dict[str, Dict[str, FrozenSet[LockToken]]] = {}

    # --------------------------------------------------------------- locks
    def _discover_locks(self) -> None:
        for cm in self.prog.classes.values():
            groups: Dict[str, str] = {}
            conds: List[Tuple[str, ast.Call]] = []
            for meth in cm.methods.values():
                for node in ast.walk(meth):
                    if not (isinstance(node, ast.Assign)
                            and len(node.targets) == 1
                            and isinstance(node.targets[0], ast.Attribute)
                            and isinstance(node.targets[0].value, ast.Name)
                            and node.targets[0].value.id == "self"
                            and isinstance(node.value, ast.Call)):
                        continue
                    attr = node.targets[0].attr
                    resolved = cm.mod.resolve(node.value.func)
                    if resolved in _LOCK_CTORS:
                        groups[attr] = attr
                    elif resolved == _COND_CTOR:
                        conds.append((attr, node.value))
            for attr, call in conds:  # second pass: alias wrapped locks
                wrapped = None
                if call.args:
                    a0 = call.args[0]
                    if isinstance(a0, ast.Attribute) \
                            and isinstance(a0.value, ast.Name) \
                            and a0.value.id == "self":
                        wrapped = groups.get(a0.attr)
                groups[attr] = wrapped if wrapped is not None else attr
            if groups:
                self.class_locks[cm.qualname] = groups
        for mod in self.prog.modules.values():
            names: Set[str] = set()
            for node in mod.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call) \
                        and mod.resolve(node.value.func) in (
                            _LOCK_CTORS | {_COND_CTOR}):
                    names.add(node.targets[0].id)
            if names:
                self.module_locks[mod.path] = names

    def lock_groups(self, cls_qual: str) -> Dict[str, str]:
        return self.class_locks.get(cls_qual, {})

    def class_tokens(self, cls_qual: str) -> Set[LockToken]:
        return {("C", cls_qual, g)
                for g in set(self.lock_groups(cls_qual).values())}

    #: attr names that ARE locks/conditions for a class (never "guarded
    #: data" themselves)
    def lock_attrs(self, cls_qual: str) -> Set[str]:
        return set(self.lock_groups(cls_qual))

    # --------------------------------------------------------------- facts
    def _build_facts(self) -> None:
        for mod in self.prog.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                owner = self.prog.owner_class(mod, node)
                if owner is not None:
                    key = method_key(owner.qualname, node.name)
                elif node in [n for n in mod.tree.body]:
                    fq = self.prog.resolve_function(
                        mod, ast.Name(id=node.name))
                    key = f"f:{fq}" if fq else \
                        f"f:{mod.path}::{node.name}"
                else:
                    continue  # defs nested in defs run in their own scope
                facts = FunctionFacts(key, mod, node, owner)
                _FactsWalker(self, facts).run()
                self.facts[key] = facts
        # Thread subclass `run` methods are entries too
        for cm in self.prog.classes.values():
            for base in cm.node.bases:
                if cm.mod.resolve(base) == "threading.Thread" \
                        and "run" in cm.methods:
                    self.thread_entries.add(method_key(cm.qualname, "run"))

    # --------------------------------------------------------- reachability
    def _reach_closure(self) -> Set[FuncKey]:
        edges: Dict[FuncKey, Set[FuncKey]] = {}
        for key, facts in self.facts.items():
            outs = edges.setdefault(key, set())
            for c in facts.calls:
                if c.callee is not None and c.callee in self.facts:
                    outs.add(c.callee)
            self.thread_entries.update(
                t for t in facts.spawn_targets if t in self.facts)
        seen: Set[FuncKey] = set()
        frontier = list(self.thread_entries & set(self.facts))
        while frontier:
            k = frontier.pop()
            if k in seen:
                continue
            seen.add(k)
            frontier.extend(edges.get(k, ()))
        return seen

    def class_is_threaded(self, cls_qual: str) -> bool:
        """True when some method of the class runs on a spawned thread —
        the precondition for any cross-thread attribute race."""
        prefix = f"m:{cls_qual}."
        return any(k.startswith(prefix) for k in self.thread_reachable)

    # --------------------------------------------------------- entry-held
    def entry_held(self, cls_qual: str) -> Dict[str, FrozenSet[LockToken]]:
        """Must-hold lock set at entry per method of ``cls_qual``.

        A leading-underscore helper called ONLY from same-class sites that
        hold the lock inherits it (``_finish_locked``); public methods and
        thread entries start with nothing held.  Computed as a decreasing
        fixpoint (init: all own-class tokens for eligible helpers)."""
        if cls_qual in self._entry_held:
            return self._entry_held[cls_qual]
        cm = self.prog.classes.get(cls_qual)
        tokens = frozenset(self.class_tokens(cls_qual))
        methods = list(cm.methods) if cm is not None else []
        sites: Dict[str, List[Tuple[str, FrozenSet[LockToken]]]] = \
            {m: [] for m in methods}
        for m in methods:
            facts = self.facts.get(method_key(cls_qual, m))
            if facts is None:
                continue
            for c in facts.calls:
                if c.callee is None or not c.callee.startswith(
                        f"m:{cls_qual}."):
                    continue
                callee_name = c.callee[len(f"m:{cls_qual}."):]
                if callee_name in sites:
                    sites[callee_name].append((m, c.held_tokens()))

        def eligible(m: str) -> bool:
            return (m.startswith("_") and not m.startswith("__")
                    and bool(sites[m])
                    and method_key(cls_qual, m) not in self.thread_entries)

        entry: Dict[str, FrozenSet[LockToken]] = {
            m: (tokens if eligible(m) else frozenset()) for m in methods}
        changed = True
        while changed:
            changed = False
            for m in methods:
                if not eligible(m):
                    continue
                new = None
                for caller, held in sites[m]:
                    eff = held | entry.get(caller, frozenset())
                    new = eff if new is None else (new & eff)
                new = new if new is not None else frozenset()
                if new != entry[m]:
                    entry[m] = new
                    changed = True
        self._entry_held[cls_qual] = entry
        return entry

    # ------------------------------------------------------------- queries
    def methods_of(self, cls_qual: str) -> Iterator[Tuple[str, FunctionFacts]]:
        prefix = f"m:{cls_qual}."
        for key, facts in self.facts.items():
            if key.startswith(prefix):
                yield key[len(prefix):], facts

    def intraclass_callsite_counts(self, cls_qual: str) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for _m, facts in self.methods_of(cls_qual):
            for c in facts.calls:
                if c.callee is not None and c.callee.startswith(
                        f"m:{cls_qual}."):
                    name = c.callee[len(f"m:{cls_qual}."):]
                    counts[name] = counts.get(name, 0) + 1
        return counts


class _FactsWalker:
    """Structural walk of one function body with a held-lock environment.

    Nested defs/lambdas/classes are skipped (their bodies run in their own
    scope and are analyzed separately); ``with`` statements stack and
    un-stack lock tokens; everything else is visited expression-wise at
    the current held-set.
    """

    def __init__(self, model: ConcurrencyModel, facts: FunctionFacts):
        self.model = model
        self.prog = model.prog
        self.facts = facts
        self.mod = facts.mod
        self.owner = facts.owner
        self.env = self.prog.local_env(self.mod, facts.fn)

    def run(self) -> None:
        self._stmts(self.facts.fn.body, {})

    # ------------------------------------------------------------ held env
    def _lock_token(self, expr: ast.AST) -> Optional[LockToken]:
        if isinstance(expr, ast.Attribute):
            base_t = self.prog.expr_type(self.mod, self.owner, self.env,
                                         expr.value)
            if base_t is not None:
                groups = self.model.lock_groups(base_t)
                if expr.attr in groups:
                    return ("C", base_t, groups[expr.attr])
        elif isinstance(expr, ast.Name):
            if expr.id in self.model.module_locks.get(self.mod.path, ()):
                return ("M", self.mod.path, expr.id)
        return None

    # ------------------------------------------------------------- walking
    def _stmts(self, body: List[ast.stmt],
               held: Dict[LockToken, ast.AST]) -> None:
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, s: ast.stmt, held: Dict[LockToken, ast.AST]) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            acquired: List[LockToken] = []
            for item in s.items:
                self._expr(item.context_expr, held)
                tok = self._lock_token(item.context_expr)
                if tok is not None:
                    self.facts.acquires.append(Acquire(
                        tok, item.context_expr,
                        tuple(sorted(held.items(), key=str))))
                    if tok not in held:
                        held[tok] = item.context_expr
                        acquired.append(tok)
            self._stmts(s.body, held)
            for tok in acquired:
                del held[tok]
            return
        if isinstance(s, ast.If):
            self._expr(s.test, held)
            self._stmts(s.body, held)
            self._stmts(s.orelse, held)
            return
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter, held)
            self._expr(s.target, held)
            self._stmts(s.body, held)
            self._stmts(s.orelse, held)
            return
        if isinstance(s, ast.While):
            self._expr(s.test, held)
            self._stmts(s.body, held)
            self._stmts(s.orelse, held)
            return
        if isinstance(s, ast.Try):
            self._stmts(s.body, held)
            for h in s.handlers:
                self._stmts(h.body, held)
            self._stmts(s.orelse, held)
            self._stmts(s.finalbody, held)
            return
        if hasattr(ast, "Match") and isinstance(s, ast.Match):
            self._expr(s.subject, held)
            for case in s.cases:
                if case.guard is not None:
                    self._expr(case.guard, held)
                self._stmts(case.body, held)
            return
        # simple statement: visit every expression it holds
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.expr):
                self._expr(child, held)

    def _expr(self, e: ast.AST, held: Dict[LockToken, ast.AST]) -> None:
        if isinstance(e, (ast.Lambda, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            return  # deferred bodies don't run here
        if isinstance(e, ast.Attribute):
            self._record_access(e, held)
        elif isinstance(e, ast.Call):
            self._record_call(e, held)
        for child in ast.iter_child_nodes(e):
            self._expr(child, held)

    def _record_access(self, node: ast.Attribute,
                       held: Dict[LockToken, ast.AST]) -> None:
        if not (isinstance(node.value, ast.Name)
                and node.value.id == "self" and self.owner is not None):
            return
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        self.facts.accesses.append(Access(
            node.attr, write, node,
            frozenset(held)))

    def _record_call(self, node: ast.Call,
                     held: Dict[LockToken, ast.AST]) -> None:
        callee: Optional[FuncKey] = None
        recv_type: Optional[str] = None
        recv_token: Optional[LockToken] = None
        func = node.func
        if isinstance(func, ast.Attribute):
            recv_type = self.prog.expr_type(self.mod, self.owner, self.env,
                                            func.value)
            recv_token = self._lock_token(func.value)
            if recv_type is not None:
                cm = self.prog.classes.get(recv_type)
                if cm is not None and func.attr in cm.methods:
                    callee = method_key(recv_type, func.attr)
        else:
            cm = self.prog.resolve_class(self.mod, func)
            if cm is not None and "__init__" in cm.methods:
                callee = method_key(cm.qualname, "__init__")
            else:
                fq = self.prog.resolve_function(self.mod, func)
                if fq is not None:
                    callee = f"f:{fq}"
        self.facts.calls.append(CallFact(
            node, callee, recv_type, recv_token,
            tuple(sorted(held.items(), key=str))))
        # thread spawn? resolve the target callable
        resolved = self.mod.resolve(func)
        kw_name = _THREAD_CTORS.get(resolved or "")
        if kw_name is not None:
            target = None
            for kw in node.keywords:
                if kw.arg == kw_name:
                    target = kw.value
            if target is None and resolved == "threading.Timer" \
                    and len(node.args) >= 2:
                target = node.args[1]
            if target is not None:
                tkey = self._callable_key(target)
                if tkey is not None:
                    self.facts.spawn_targets.append(tkey)

    def _callable_key(self, expr: ast.AST) -> Optional[FuncKey]:
        if isinstance(expr, ast.Attribute):
            base_t = self.prog.expr_type(self.mod, self.owner, self.env,
                                         expr.value)
            if base_t is not None:
                return method_key(base_t, expr.attr)
        elif isinstance(expr, ast.Name):
            fq = self.prog.resolve_function(self.mod, expr)
            if fq is not None:
                return f"f:{fq}"
        return None
