"""Shared machinery for the lifecycle suite: the acquire registry,
receiver classification, per-function acquire events with alias
closure, and the interprocedural obligation summaries.

The acquire registry is the extension point: each :class:`AcquireSpec`
names the calls that create an obligation, what counts as discharging
it, and how strictly the receiver must be identified.  Receivers are
classified three ways, best evidence first: a constructor the model saw
(``self._sem = threading.Semaphore(...)``), the program-wide type
inference (:meth:`ProgramInfo.expr_type` resolving to ``PageAllocator``),
then a conservative name hint (``alloc`` / ``sem`` / ``lock`` in the
receiver's dotted text) so un-annotated helper parameters still match.

Discharge is deliberately broader than release: returning the resource
hands the obligation to the caller; storing it into ``self``-rooted
state (a page table, a pending-COW list, an LRU ledger) transfers
ownership to the object; and a call into a helper whose summary says
"releases this parameter" (or "releases everything of this kind")
discharges at the call site — the same inheritance direction T1 uses
for lock facts.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from pdnlp_tpu_torch.analysis.cfg import CFG, build_cfg
from pdnlp_tpu_torch.analysis.core import (
    ClassModel, ModuleInfo, ProgramInfo, dotted_name,
)

# ------------------------------------------------------------------ registry

@dataclasses.dataclass(frozen=True)
class AcquireSpec:
    """One acquire/release protocol the L1 analysis enforces."""

    kind: str                       # short id used in messages/summaries
    methods: FrozenSet[str]         # method names that acquire
    releasers: FrozenSet[str]       # method names that discharge
    funcs: FrozenSet[str] = frozenset()   # dotted callables that acquire
    #: methods whose FIRST ARGUMENT is the resource (``share(pages,
    #: owner)``); all other acquires bind their resource to the result
    arg_methods: FrozenSet[str] = frozenset()
    recv_types: FrozenSet[str] = frozenset()  # class simple names / dotted
    recv_hint: Optional[str] = None  # substring of receiver text (lowered)
    #: True: a leak is only a leak when the escape is an exception edge
    #: (the normal-path "release" lives in another function by design —
    #: e.g. standby deactivation is re-activated by a later control law)
    exc_only: bool = False
    hint: str = ""


def _fs(*items: str) -> FrozenSet[str]:
    return frozenset(items)


#: the default registry.  Extend by appending an :class:`AcquireSpec`
#: (tests monkeypatch this; downstream repos can too).
ACQUIRE_REGISTRY: Tuple[AcquireSpec, ...] = (
    AcquireSpec(
        kind="kv-pages",
        methods=_fs("alloc", "share"),
        arg_methods=_fs("share"),
        # ``transfer`` discharges the SENDER side of a custody move; the
        # disaggregation staging wrapper ``stage_handoff`` (which calls
        # transfer onto the staged owner and returns that key) CREATES
        # the receiver-side obligation — its result owes a
        # release_owner on every dispatch outcome
        funcs=_fs("pdnlp_tpu_torch.serve.kvpage.stage_handoff"),
        releasers=_fs("release", "release_owner", "release_if_idle",
                      "transfer"),
        recv_types=_fs("PageAllocator"),
        recv_hint="alloc",
        hint="release/release_owner the pages on every exit (wrap the "
             "post-acquire tail in try/except BaseException), or commit "
             "them into the page table / a ledger before anything can "
             "raise",
    ),
    AcquireSpec(
        kind="handoff-conn",
        methods=_fs(),
        funcs=_fs("pdnlp_tpu_torch.serve.handoff.HandoffChannel",
                  "socket.create_connection"),
        releasers=_fs("close"),
        hint="close the handoff channel/socket on every path "
             "(try/finally or use it as a context manager), or commit "
             "it into the router's channel table before anything can "
             "raise",
    ),
    AcquireSpec(
        kind="semaphore",
        methods=_fs("acquire"),
        releasers=_fs("release"),
        recv_types=_fs("threading.Semaphore", "threading.BoundedSemaphore"),
        recv_hint="sem",
        hint="pair .acquire() with .release() in a finally, or use "
             "`with sem:`",
    ),
    AcquireSpec(
        kind="standby",
        methods=_fs("deactivate_replica"),
        releasers=_fs("activate_replica"),
        exc_only=True,
        hint="an exception between deactivate_replica and the state "
             "commit strands the replica in standby — reactivate on "
             "failure or record the index first",
    ),
    AcquireSpec(
        kind="tmpfile",
        methods=_fs(),
        funcs=_fs("tempfile.mkstemp", "tempfile.mkdtemp",
                  "tempfile.NamedTemporaryFile"),
        releasers=_fs("remove", "unlink", "replace", "rename", "rmtree",
                      "move", "cleanup", "close"),
        hint="remove/os.replace the temp artifact on every path "
             "(try/finally), or use it as a context manager",
    ),
)

#: constructor dotted names -> receiver kind, for receivers the
#: whole-program type inference cannot see (stdlib primitives)
CTOR_KINDS: Dict[str, str] = {
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
    "threading.Lock": "lock",
    "threading.RLock": "lock",
    "threading.Condition": "lock",
    "multiprocessing.Lock": "lock",
    "multiprocessing.RLock": "lock",
}

#: scanned resource classes -> receiver kind
RESOURCE_CLASSES: Dict[str, str] = {
    "PageAllocator": "kv-pages",
}

#: mutating container methods that, on a ``self``-rooted receiver,
#: count as storing the resource into tracked object state
_STORE_METHODS = _fs("append", "appendleft", "add", "insert", "extend",
                     "update", "setdefault", "put", "put_nowait")


def expr_text(node: ast.AST) -> str:
    dn = dotted_name(node)
    if dn is not None:
        return dn
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - very old ast shapes
        return ""


def _hint_kind(text: str) -> Optional[str]:
    low = text.lower()
    if "alloc" in low:
        return "kv-pages"
    if "sem" in low:
        return "semaphore"
    if "lock" in low or "mutex" in low or "cond" in low:
        return "lock"
    return None


def simple_names(expr: ast.AST) -> Set[str]:
    """Names composing a *simple* value expression (names, containers of
    names, concatenations) — what reverse alias linking accepts.  A call
    result is a new value, so calls contribute nothing here."""
    out: Set[str] = set()

    def walk(e: ast.AST) -> None:
        if isinstance(e, ast.Name):
            out.add(e.id)
        elif isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            for v in e.elts:
                walk(v)
        elif isinstance(e, ast.BinOp):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, ast.Starred):
            walk(e.value)
        elif isinstance(e, ast.IfExp):
            walk(e.body)
            walk(e.orelse)

    walk(expr)
    return out


def mentions(expr: ast.AST, names: Set[str]) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(expr))


def root_name(target: ast.AST) -> Optional[str]:
    """The base Name of a Subscript/Attribute chain (``self`` for
    ``self._table[slot]``), or None."""
    node = target
    while isinstance(node, (ast.Subscript, ast.Attribute)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


# ------------------------------------------------------------------- events

class AcquireEvent:
    """One acquire call inside one function: the spec it matched, the
    statement it lives in, the resource names it binds, and its
    receiver text (release calls on the same receiver discharge it)."""

    __slots__ = ("spec", "call", "stmt", "names", "recv_text")

    def __init__(self, spec: AcquireSpec, call: ast.Call, stmt: ast.stmt,
                 names: Set[str], recv_text: str):
        self.spec = spec
        self.call = call
        self.stmt = stmt
        self.names = names
        self.recv_text = recv_text


class FuncInfo:
    """Per-function lifecycle facts, computed lazily and cached."""

    __slots__ = ("key", "mod", "fn", "owner", "events", "returns_kind",
                 "released_params", "releases_kinds", "_cfg")

    def __init__(self, key: str, mod: ModuleInfo, fn: ast.AST,
                 owner: Optional[ClassModel]):
        self.key = key
        self.mod = mod
        self.fn = fn
        self.owner = owner
        self.events: List[AcquireEvent] = []
        #: spec kind when this function acquires and RETURNS the
        #: resource — its call sites inherit the obligation
        self.returns_kind: Optional[str] = None
        #: parameter names this function releases (caller-side discharge
        #: of arguments passed in those positions)
        self.released_params: Set[str] = set()
        #: kinds for which this function calls an owner-scoped releaser
        #: (``release_owner`` and friends) — a call discharges every
        #: event of that kind at the call site
        self.releases_kinds: Set[str] = set()
        self._cfg: Optional[CFG] = None

    @property
    def cfg(self) -> CFG:
        if self._cfg is None:
            self._cfg = build_cfg(self.fn)
        return self._cfg

    def param_names(self) -> List[str]:
        args = getattr(self.fn, "args", None)
        if args is None:
            return []
        names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
        if self.owner is not None and names and names[0] in ("self", "cls"):
            names = names[1:]
        return names


def func_key(owner: Optional[ClassModel], mod: ModuleInfo,
             fn: ast.AST) -> str:
    name = getattr(fn, "name", "<lambda>")
    if owner is not None:
        return f"m:{owner.qualname}.{name}"
    return f"f:{mod.path}:{name}:{getattr(fn, 'lineno', 0)}"


# -------------------------------------------------------------------- model

class LifecycleModel:
    """Whole-program lifecycle facts: ctor-classified receivers, per-
    function acquire events, and the helper summaries the interprocedural
    discharge matching reads.  Built once per :class:`ProgramInfo` and
    cached on it (:func:`get_lifecycle`)."""

    def __init__(self, prog: ProgramInfo):
        self.prog = prog
        #: (class qualname, attr) -> receiver kind, from ctor scans
        self._attr_kinds: Dict[Tuple[str, str], str] = {}
        #: id(fn) -> {local name -> receiver kind}
        self._local_kinds: Dict[int, Dict[str, str]] = {}
        self._env_cache: Dict[int, Dict[str, str]] = {}
        self.funcs: Dict[str, FuncInfo] = {}
        self._by_node: Dict[int, FuncInfo] = {}
        self._scan_ctors()
        self._scan_functions()
        self._summarize()

    # ------------------------------------------------------------ ctor scan
    def _ctor_kind(self, mod: ModuleInfo, value: ast.AST) -> Optional[str]:
        if not isinstance(value, ast.Call):
            return None
        resolved = mod.resolve(value.func)
        if resolved in CTOR_KINDS:
            return CTOR_KINDS[resolved]
        cm = self.prog.resolve_class(mod, value.func)
        if cm is not None and cm.name in RESOURCE_CLASSES:
            return RESOURCE_CLASSES[cm.name]
        return None

    def _scan_ctors(self) -> None:
        for mod in self.prog.modules.values():
            for cm in [c for c in self.prog.classes.values()
                       if c.mod is mod]:
                for meth in cm.methods.values():
                    for node in ast.walk(meth):
                        if not (isinstance(node, ast.Assign)
                                and len(node.targets) == 1):
                            continue
                        t = node.targets[0]
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            kind = self._ctor_kind(mod, node.value)
                            if kind is not None:
                                self._attr_kinds[(cm.qualname, t.attr)] = kind

    def _locals_of(self, mod: ModuleInfo, fn: ast.AST) -> Dict[str, str]:
        cached = self._local_kinds.get(id(fn))
        if cached is None:
            cached = {}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    kind = self._ctor_kind(mod, node.value)
                    if kind is not None:
                        cached[node.targets[0].id] = kind
            self._local_kinds[id(fn)] = cached
        return cached

    def _env_of(self, mod: ModuleInfo, fn: ast.AST) -> Dict[str, str]:
        env = self._env_cache.get(id(fn))
        if env is None:
            env = self.prog.local_env(mod, fn)
            self._env_cache[id(fn)] = env
        return env

    # -------------------------------------------------- receiver classify
    def receiver_kind(self, mod: ModuleInfo, owner: Optional[ClassModel],
                      fn: ast.AST, recv: ast.AST) -> Optional[str]:
        if (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self" and owner is not None):
            kind = self._attr_kinds.get((owner.qualname, recv.attr))
            if kind is not None:
                return kind
        if isinstance(recv, ast.Name):
            kind = self._locals_of(mod, fn).get(recv.id)
            if kind is not None:
                return kind
        t = self.prog.expr_type(mod, owner, self._env_of(mod, fn), recv)
        if t is not None:
            if t in CTOR_KINDS:
                return CTOR_KINDS[t]
            simple = t.split(".")[-1]
            if simple in RESOURCE_CLASSES:
                return RESOURCE_CLASSES[simple]
        return _hint_kind(expr_text(recv))

    def _spec_matches_recv(self, spec: AcquireSpec, mod: ModuleInfo,
                           owner: Optional[ClassModel], fn: ast.AST,
                           recv: ast.AST) -> bool:
        if not spec.recv_types and spec.recv_hint is None:
            return True  # method name alone identifies the protocol
        kind = self.receiver_kind(mod, owner, fn, recv)
        return kind == spec.kind

    def match_acquire(self, mod: ModuleInfo, owner: Optional[ClassModel],
                      fn: ast.AST, call: ast.Call) -> Optional[AcquireSpec]:
        if isinstance(call.func, ast.Attribute):
            meth = call.func.attr
            for spec in ACQUIRE_REGISTRY:
                if meth in spec.methods and self._spec_matches_recv(
                        spec, mod, owner, fn, call.func.value):
                    return spec
        resolved = mod.resolve(call.func)
        if resolved is not None:
            for spec in ACQUIRE_REGISTRY:
                if resolved in spec.funcs:
                    return spec
        return None

    # ------------------------------------------------------ function scan
    def _scan_functions(self) -> None:
        for mod in self.prog.modules.values():
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                owner = self.prog.owner_class(mod, node)
                fi = FuncInfo(func_key(owner, mod, node), mod, node, owner)
                self.funcs.setdefault(fi.key, fi)
                self._by_node[id(node)] = fi

    def info_for(self, fn: ast.AST) -> Optional[FuncInfo]:
        return self._by_node.get(id(fn))

    def resolve_callee(self, mod: ModuleInfo, owner: Optional[ClassModel],
                       fn: ast.AST, call: ast.Call) -> Optional[FuncInfo]:
        f = call.func
        if isinstance(f, ast.Attribute):
            recv_cm: Optional[ClassModel] = None
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and owner is not None:
                recv_cm = owner
            else:
                t = self.prog.expr_type(mod, owner, self._env_of(mod, fn),
                                        f.value)
                if t is not None:
                    recv_cm = self.prog.classes.get(t)
            if recv_cm is not None:
                target = recv_cm.methods.get(f.attr)
                if target is not None:
                    return self._by_node.get(id(target))
            return None
        qual = self.prog.resolve_function(mod, f)
        if qual is not None:
            found = self.prog.function_named(qual)
            if found is not None:
                return self._by_node.get(id(found[1]))
        return None

    # -------------------------------------------------------- event layer
    def _nearest_stmt(self, mod: ModuleInfo, node: ast.AST,
                      cfg: CFG) -> Optional[ast.AST]:
        p: Optional[ast.AST] = node
        while p is not None:
            if isinstance(p, ast.stmt) and cfg.node_of(p) is not None:
                return p
            p = mod.parents.get(p)
        return None

    def events_of(self, fi: FuncInfo) -> List[AcquireEvent]:
        """Acquire events in ``fi`` (cached).  ``with``-managed acquires
        and acquires whose result is immediately returned (obligation
        handed to the caller) are excluded — the latter instead marks
        the function as acquire-returning for its call sites."""
        if fi.events:
            return fi.events
        mod, fn, owner = fi.mod, fi.fn, fi.owner
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

        events: List[AcquireEvent] = []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or in_nested(node):
                continue
            spec = self.match_acquire(mod, owner, fn, node)
            if spec is None:
                continue
            stmt = self._nearest_stmt(mod, node, fi.cfg)
            if stmt is None:
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)) and any(
                    node in ast.walk(item.context_expr)
                    for item in stmt.items):
                continue  # context-managed: released by construction
            names: Set[str] = set()
            recv_text = (expr_text(node.func.value)
                         if isinstance(node.func, ast.Attribute) else "")
            meth = (node.func.attr
                    if isinstance(node.func, ast.Attribute) else None)
            committed = False
            if isinstance(stmt, ast.Assign) and node in ast.walk(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, (ast.Attribute, ast.Subscript)) \
                            and root_name(t) == "self":
                        committed = True  # stored into object state at birth
            if committed and not names:
                continue
            if not names and meth in spec.arg_methods and node.args:
                names |= simple_names(node.args[0])
            if isinstance(stmt, ast.Return):
                fi.returns_kind = spec.kind
                continue
            events.append(AcquireEvent(spec, node, stmt, names, recv_text))
        fi.events = events
        return events

    # --------------------------------------------------------- summaries
    def _summarize(self) -> None:
        for fi in self.funcs.values():
            params = set(fi.param_names())
            self.events_of(fi)  # populates returns_kind as a side effect
            for node in ast.walk(fi.fn):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)):
                    continue
                meth = node.func.attr
                for spec in ACQUIRE_REGISTRY:
                    if meth not in spec.releasers:
                        continue
                    if not self._spec_matches_recv(spec, fi.mod, fi.owner,
                                                   fi.fn, node.func.value):
                        continue
                    arg_names = {n for a in node.args
                                 for n in simple_names(a)}
                    hit = arg_names & params
                    if hit:
                        fi.released_params |= hit
                    else:
                        # owner-scoped release (release_owner et al):
                        # discharges every same-kind obligation around
                        # the call site
                        fi.releases_kinds.add(spec.kind)


def get_lifecycle(prog: ProgramInfo) -> LifecycleModel:
    model = getattr(prog, "_lifecycle_model", None)
    if model is None:
        model = LifecycleModel(prog)
        prog._lifecycle_model = model
    return model
