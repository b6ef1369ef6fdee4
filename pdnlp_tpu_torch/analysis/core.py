"""torchlint core — findings, per-module AST context, and the rule registry.

The twin of ``pdnlp_tpu/analysis/core.py`` for the PyTorch port.  The
analyzer is pure ``ast``: it imports neither torch nor the modules it
scans, so it runs in milliseconds on any machine, a card or none.  Every
rule works from the same :class:`ModuleInfo` view of a file: source lines,
the parsed tree, an import-alias map that canonicalizes ``F.dropout`` ->
``torch.nn.functional.dropout``, and the *captured set*: the code that
runs inside a CUDA graph capture, where a host read, a host-side branch on
a tensor or a host read of a generator's state is frozen into the graph
(or raises) instead of running at every replay.

Rules are small classes registered with :func:`register`; the CLI
(``python -m pdnlp_tpu_torch.analysis``) discovers them through
:func:`all_rules`.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

# --------------------------------------------------------------------- finding

@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at ``path:line``."""

    rule_id: str
    path: str          # repo-relative, posix separators
    line: int
    col: int
    message: str
    hint: str          # suggested rewrite (--fix-hints / JSON output)
    snippet: str = ""  # stripped source line, for human output

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule_id,
            "file": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
        }

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule_id)


# ---------------------------------------------------------------- suppressions

_SUPPRESS_RE = re.compile(r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s]+)")


class Suppressions:
    """Inline ``# torchlint: disable=R1[,R2]`` (or ``disable=all``) markers.

    A marker on a code line suppresses that line; a marker on a
    comment-only line suppresses the next line (so a hint can sit above a
    long expression).
    """

    def __init__(self, source_lines: List[str]):
        self._by_line: Dict[int, Set[str]] = {}
        for i, text in enumerate(source_lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            rules = {t.strip().upper() for t in m.group(1).split(",") if t.strip()}
            self._by_line.setdefault(i, set()).update(rules)
            if text.lstrip().startswith("#"):  # comment-only: covers next line
                self._by_line.setdefault(i + 1, set()).update(rules)

    def is_suppressed(self, line: int, rule_id: str) -> bool:
        rules = self._by_line.get(line)
        return bool(rules) and (rule_id.upper() in rules or "ALL" in rules)


# ------------------------------------------------------------------- the tree

#: calls whose callable argument runs captured (replayed as a CUDA graph,
#: or compiled into one): the port's K-step capture
#: (``pdnlp_tpu_torch.train.steps.build_multi_step``) and torch's own
CAPTURE_TRANSFORMS = {
    "torch.cuda.make_graphed_callables",
    "torch.cuda.graphs.make_graphed_callables",
    "torch.compile",
    "pdnlp_tpu_torch.train.steps.build_multi_step",
    "build_multi_step",
}

#: context managers whose body is recorded into a CUDA graph
GRAPH_CONTEXTS = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleInfo:
    """Everything the rules need to know about one file, computed once."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.suppressions = Suppressions(self.lines)
        self.aliases = self._collect_aliases(tree)
        self._captured: Optional[Set[ast.AST]] = None
        self._blocks: Optional[List[ast.With]] = None
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    # ------------------------------------------------------------- imports
    @staticmethod
    def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def imports_torch(self) -> bool:
        """Does the module import torch (any part of it)?"""
        return any(a == "torch" or a.startswith("torch.")
                   for a in self.aliases.values())

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path of a Name/Attribute, through import aliases.

        ``F.dropout`` -> ``torch.nn.functional.dropout`` (after ``import
        torch.nn.functional as F``); a name with no alias resolves to
        itself.
        """
        dn = dotted_name(node)
        if dn is None:
            return None
        head, _, rest = dn.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    def resolves_to(self, node: ast.AST, targets: Set[str]) -> bool:
        r = self.resolve(node)
        if r is None:
            return False
        if r in targets:
            return True
        # `np` vs `numpy`: normalize the conventional alias when the file
        # used a bare `import np`-style name that we could not see imported
        if r.startswith("np."):
            return ("numpy." + r[3:]) in targets
        return False

    # ------------------------------------------------------------- parents
    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    # ----------------------------------------------------- captured code
    def graph_blocks(self) -> List[ast.With]:
        """``with torch.cuda.graph(...):`` statements: their bodies are
        recorded into a CUDA graph."""
        if self._blocks is None:
            self._blocks = [
                n for n in ast.walk(self.tree)
                if isinstance(n, (ast.With, ast.AsyncWith)) and any(
                    isinstance(it.context_expr, ast.Call)
                    and self.resolves_to(it.context_expr.func, GRAPH_CONTEXTS)
                    for it in n.items)]
        return self._blocks

    def captured_functions(self) -> Set[ast.AST]:
        """FunctionDef / Lambda nodes whose bodies run inside a capture.

        Detected structurally, as JAX's core finds its traced set:
        - ``@torch.compile`` / ``@torch.compile(...)`` decorators;
        - a local function name or a lambda passed to a
          :data:`CAPTURE_TRANSFORMS` call (``build_multi_step(step, dev)``,
          ``torch.cuda.make_graphed_callables(fn, ...)``);
        - the function(s) *returned by* a local builder that is itself
          passed to one (``build_multi_step(build_train_step(...))`` marks
          the ``train_step`` def that ``build_train_step`` returns);
        - what a captured body or a ``with torch.cuda.graph(...)`` block
          reaches by call inside the module: a module-level function or a
          nested def called by name, a method of the enclosing class
          called on ``self``;
        - any def nested inside a captured def.
        """
        if self._captured is not None:
            return self._captured

        defs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)

        captured: Set[ast.AST] = set()

        def mark_returned_defs(builder: ast.AST) -> None:
            """The builder idiom: mark local defs its return statements name."""
            for n in ast.walk(builder):
                if isinstance(n, ast.Return) and isinstance(n.value, ast.Name):
                    for d in defs_by_name.get(n.value.id, []):
                        captured.add(d)

        def mark_func_arg(arg: ast.AST) -> None:
            if isinstance(arg, ast.Lambda):
                captured.add(arg)
            elif isinstance(arg, ast.Name):
                for d in defs_by_name.get(arg.id, []):
                    captured.add(d)
            elif isinstance(arg, ast.Call):
                fn = arg.func
                if self.resolves_to(fn, CAPTURE_TRANSFORMS) and arg.args:
                    mark_func_arg(arg.args[0])
                else:
                    name = dotted_name(fn)
                    if name and "." not in name:
                        for d in defs_by_name.get(name, []):
                            mark_returned_defs(d)

        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if self._is_capture_transform_expr(dec):
                        captured.add(node)
            elif isinstance(node, ast.Call):
                if self.resolves_to(node.func, CAPTURE_TRANSFORMS) \
                        and node.args:
                    mark_func_arg(node.args[0])

        free_defs = {name: [d for d in ds if not isinstance(
            self.parents.get(d), ast.ClassDef)]
            for name, ds in defs_by_name.items()}

        def methods(owner: Optional[ast.ClassDef], name: str) -> List:
            return [] if owner is None else [
                d for d in owner.body if isinstance(
                    d, (ast.FunctionDef, ast.AsyncFunctionDef))
                and d.name == name]

        def self_attrs(expr: ast.AST) -> Iterator[str]:
            for n in ast.walk(expr):
                if isinstance(n, ast.Attribute) and isinstance(
                        n.value, ast.Name) and n.value.id == "self":
                    yield n.attr

        def reached(region: ast.AST, body: List[ast.stmt]) -> Set[ast.AST]:
            """The defs a region calls by name or on ``self``, and the
            methods a local it calls was bound to (``fn = fn or
            self._forward`` ... ``fn(x)``)."""
            owner = self._owner_class(region)
            scope = region if isinstance(region, _FUNCS) \
                else self.enclosing_function(region)
            out: Set[ast.AST] = set()
            for stmt in body:
                for n in ast.walk(stmt):
                    if not isinstance(n, ast.Call):
                        continue
                    if isinstance(n.func, ast.Name):
                        out.update(free_defs.get(n.func.id, []))
                        for a in ast.walk(scope) if scope is not None else ():
                            if isinstance(a, ast.Assign) and any(
                                    isinstance(t, ast.Name)
                                    and t.id == n.func.id for t in a.targets):
                                for attr in self_attrs(a.value):
                                    out.update(methods(owner, attr))
                    elif isinstance(n.func, ast.Attribute) and isinstance(
                            n.func.value, ast.Name) \
                            and n.func.value.id == "self":
                        out.update(methods(owner, n.func.attr))
            return out

        for block in self.graph_blocks():
            captured |= reached(block, block.body)
        grew = True
        while grew:
            grew = False
            for fn in list(captured):
                body = fn.body if isinstance(fn.body, list) else [
                    ast.Expr(fn.body)]
                new = {n for n in ast.walk(fn) if n is not fn
                       and isinstance(n, _FUNCS)} | reached(fn, body)
                if new - captured:
                    captured |= new
                    grew = True

        self._captured = captured
        return captured

    def captured_regions(self) -> List[Tuple[ast.AST, List[ast.stmt]]]:
        """``(node, statements)`` of every captured region: each captured
        function's body and each ``with torch.cuda.graph(...)`` block's
        (the rules walk these; a finding in a def nested in a region is
        reported once, the set dedups)."""
        out = []
        for fn in self.captured_functions():
            out.append((fn, fn.body if isinstance(fn.body, list)
                        else [ast.Expr(fn.body)]))
        for block in self.graph_blocks():
            out.append((block, block.body))
        return out

    def region_taint(self, region: ast.AST) -> Set[str]:
        """The names that hold tensors in a region: a function's
        :meth:`tainted_names`; for a ``with`` block, its enclosing
        function's."""
        if isinstance(region, _FUNCS):
            return self.tainted_names(region)
        fn = self.enclosing_function(region)
        return self.tainted_names(fn) if fn is not None else set()

    def _owner_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        """The class whose method holds ``node`` (through nested blocks,
        not through a nested def's own scope beyond the method)."""
        p = self.parents.get(node)
        while p is not None:
            if isinstance(p, ast.ClassDef):
                return p
            p = self.parents.get(p)
        return None

    def _is_capture_transform_expr(self, dec: ast.AST) -> bool:
        """Decorator forms: ``@torch.compile``, ``@torch.compile(...)``,
        ``@partial(torch.compile, ...)``."""
        if self.resolves_to(dec, CAPTURE_TRANSFORMS):
            return True
        if isinstance(dec, ast.Call):
            if self.resolves_to(dec.func, CAPTURE_TRANSFORMS):
                return True
            if self.resolve(dec.func) == "functools.partial" and dec.args:
                return self.resolves_to(dec.args[0], CAPTURE_TRANSFORMS)
        return False

    # ---------------------------------------------------------- taint sets
    #: reads that stay on the host (a tensor's metadata), and calls of them
    STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                    "requires_grad", "layout", "itemsize", "nbytes",
                    "is_leaf", "grad_fn"}
    STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type",
                    "callable", "id", "repr", "str"}
    STATIC_METHODS = {"size", "dim", "numel", "nelement", "stride",
                      "element_size", "is_contiguous", "data_ptr",
                      "get_device", "is_floating_point", "keys"}

    def tainted_names(self, fn: ast.AST) -> Set[str]:
        """Names inside ``fn`` that (transitively) may hold tensors:
        parameters, plus assignment targets whose RHS mentions a tainted
        name *dynamically* (``x.shape`` / ``x.size(0)`` / ``len(x)`` / ``x
        is None`` read host metadata and do not propagate)."""
        args = getattr(fn, "args", None)
        tainted: Set[str] = set()
        if args is not None:
            for a in (list(args.posonlyargs) + list(args.args)
                      + list(args.kwonlyargs)):
                tainted.add(a.arg)
            if args.vararg:
                tainted.add(args.vararg.arg)
            if args.kwarg:
                tainted.add(args.kwarg.arg)

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        nested = {n for b in body for n in ast.walk(b)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)) and n is not fn}

        def in_nested(node: ast.AST) -> bool:
            p = self.parents.get(node)
            while p is not None and p is not fn:
                if p in nested:
                    return True
                p = self.parents.get(p)
            return False

        def targets_of(node: ast.AST) -> Iterator[str]:
            if isinstance(node, ast.Name):
                yield node.id
            elif isinstance(node, (ast.Tuple, ast.List)):
                for elt in node.elts:
                    yield from targets_of(elt)
            elif isinstance(node, ast.Starred):
                yield from targets_of(node.value)

        grew = True
        while grew:
            grew = False
            for b in body:
                for node in ast.walk(b):
                    if in_nested(node):
                        continue
                    pairs: List[Tuple[Iterable[str], ast.AST]] = []
                    if isinstance(node, ast.Assign):
                        pairs = [(list(targets_of(t)), node.value)
                                 for t in node.targets]
                    elif isinstance(node, ast.AnnAssign) and node.value:
                        pairs = [(list(targets_of(node.target)), node.value)]
                    elif isinstance(node, ast.AugAssign):
                        pairs = [(list(targets_of(node.target)), node.value)]
                    elif isinstance(node, ast.NamedExpr):
                        pairs = [(list(targets_of(node.target)), node.value)]
                    elif isinstance(node, ast.For):
                        pairs = [(list(targets_of(node.target)), node.iter)]
                    for names, value in pairs:
                        if self.reads_tensor(value, tainted):
                            for n in names:
                                if n not in tainted:
                                    tainted.add(n)
                                    grew = True
        return tainted

    def reads_tensor(self, expr: ast.AST, tainted: Set[str]) -> bool:
        """True when evaluating ``expr`` reads a tainted value's contents
        (a device value) — i.e. excluding the host metadata reads
        (``.shape``/``.dtype``/``.size()``/``len``/``is None``/dict
        membership)."""

        def dyn(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in tainted
            if isinstance(e, ast.Attribute):
                if e.attr in self.STATIC_ATTRS:
                    return False
                return dyn(e.value)
            if isinstance(e, ast.Subscript):
                # x.shape[0] is host metadata; x[0] is a device value
                return dyn(e.value) or dyn(e.slice)
            if isinstance(e, ast.Call):
                fname = dotted_name(e.func)
                if fname in self.STATIC_CALLS or (
                        isinstance(e.func, ast.Attribute)
                        and e.func.attr in self.STATIC_METHODS):
                    return False
                parts = [dyn(a) for a in e.args]
                parts += [dyn(k.value) for k in e.keywords if k.value]
                if isinstance(e.func, ast.Attribute):
                    parts.append(dyn(e.func.value))
                return any(parts)
            if isinstance(e, ast.Compare):
                static_ops = (ast.Is, ast.IsNot, ast.In, ast.NotIn)
                if all(isinstance(op, static_ops) for op in e.ops):
                    return False
                return any(dyn(c) for c in [e.left] + list(e.comparators))
            if isinstance(e, (ast.BoolOp,)):
                return any(dyn(v) for v in e.values)
            if isinstance(e, ast.BinOp):
                return dyn(e.left) or dyn(e.right)
            if isinstance(e, ast.UnaryOp):
                return dyn(e.operand)
            if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
                return any(dyn(v) for v in e.elts)
            if isinstance(e, ast.Dict):
                return any(dyn(v) for v in list(e.keys) + list(e.values)
                           if v is not None)
            if isinstance(e, ast.IfExp):
                return dyn(e.test) or dyn(e.body) or dyn(e.orelse)
            if isinstance(e, ast.Starred):
                return dyn(e.value)
            if isinstance(e, ast.JoinedStr):
                return any(dyn(v.value) for v in e.values
                           if isinstance(v, ast.FormattedValue))
            return False

        return dyn(expr)

    # ----------------------------------------------------------- utilities
    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def scopes(self) -> List[Tuple[str, ast.AST, List[ast.stmt]]]:
        """(name, node, body) for the module plus every def — the statement
        lists rules walk for ordered, per-scope analyses (R3/R4).  Nested
        defs appear as their own scope and are excluded from the parent's
        walk by the rules via the parents map."""
        out: List[Tuple[str, ast.AST, List[ast.stmt]]] = [
            ("<module>", self.tree, self.tree.body)]
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((node.name, node, node.body))
            elif isinstance(node, ast.Lambda):
                out.append(("<lambda>", node, [ast.Expr(node.body)]))
        return out

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        p = self.parents.get(node)
        while p is not None:
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return p
            p = self.parents.get(p)
        return None


#: (abspath, display_path) -> (stat key, ModuleInfo-or-None).  One
#: shared parse per file across the three suites and across repeated
#: ``analyze_paths`` calls (the pytest ratchet, the bench lint gate and
#: the CLI all re-scan the same surface); keyed by (mtime_ns, size) so
#: an edited file re-parses.  ModuleInfo is read-only after
#: construction (its lazy caches are idempotent), so sharing is safe.
_PARSE_CACHE: Dict[Tuple[str, str], Tuple[Tuple[int, int],
                                          Optional["ModuleInfo"]]] = {}


def parse_module(path: str, display_path: str) -> Optional[ModuleInfo]:
    """Parse one file; returns None (caller reports) on syntax errors.
    Results are memoized by (path, mtime, size) in :data:`_PARSE_CACHE`."""
    import os
    abspath = os.path.abspath(path)
    try:
        st = os.stat(abspath)
        stat_key = (st.st_mtime_ns, st.st_size)
    except OSError:
        stat_key = None
    cache_key = (abspath, display_path)
    if stat_key is not None:
        hit = _PARSE_CACHE.get(cache_key)
        if hit is not None and hit[0] == stat_key:
            return hit[1]
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
        mod: Optional[ModuleInfo] = ModuleInfo(display_path, source, tree)
    except SyntaxError:
        mod = None
    if stat_key is not None:
        _PARSE_CACHE[cache_key] = (stat_key, mod)
    return mod


# ------------------------------------------------- interprocedural program

class ClassModel:
    """One class as the whole-program analyses see it: its methods, the
    inferred types of its ``self.<attr>`` attributes, and the qualified
    name cross-module call edges resolve against."""

    def __init__(self, mod: ModuleInfo, node: ast.ClassDef,
                 qualname: str):
        self.mod = mod
        self.node = node
        self.name = node.name
        self.qualname = qualname
        self.methods: Dict[str, ast.AST] = {}
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[stmt.name] = stmt
        #: ``self.<attr>`` -> qualified class name, where inferable from
        #: ``self.x = ClassName(...)`` (or a typed local / helper return)
        self.attr_types: Dict[str, str] = {}
        #: method name -> qualified class name its return value carries
        self.return_types: Dict[str, str] = {}

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<ClassModel {self.qualname}>"


def module_dotted_name(display_path: str) -> Optional[str]:
    """``pdnlp_tpu/serve/router.py`` -> ``pdnlp_tpu.serve.router``; None
    for paths that are not importable module names (``multi-tpu-*.py``)."""
    if not display_path.endswith(".py"):
        return None
    parts = display_path[:-3].split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if not parts or not all(p.isidentifier() for p in parts):
        return None
    return ".".join(parts)


#: external classes the type inference tracks by name (never scanned, but
#: knowing "this attribute is a Thread / Queue / Event" is what lets the
#: concurrency rules judge ``.join()``/``.get()``/``.wait()`` receivers)
KNOWN_EXTERNAL_TYPES = {
    "threading.Thread", "threading.Timer", "threading.Event",
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "queue.SimpleQueue", "socket.socket",
    "concurrent.futures.ThreadPoolExecutor",
}


class ProgramInfo:
    """The whole-program view the concurrency suite runs over: every
    scanned :class:`ModuleInfo`, a class registry keyed by qualified name
    (resolved through each module's import-alias map), a module-level
    function registry for cross-module call edges, and class-level
    attribute type models so ``rep.hb.beat(...)`` resolves to
    ``Heartbeat.beat`` even across modules.

    Construction is two type-inference passes over every function body:
    pass 1 records ``self.x = ClassName(...)`` attribute types and
    builder-method return types; pass 2 re-runs with those models
    available so locals assigned from attributes/builders (and attribute
    writes THROUGH such locals, ``rep.hb = Heartbeat(...)``) resolve too.
    """

    def __init__(self, modules: List[ModuleInfo]):
        self.modules: Dict[str, ModuleInfo] = {m.path: m for m in modules}
        self.classes: Dict[str, ClassModel] = {}          # by qualname
        self._by_simple: Dict[str, List[ClassModel]] = {}  # by class name
        self._by_module: Dict[str, Dict[str, ClassModel]] = {}
        #: module-level functions: qualified name -> (ModuleInfo, def node)
        self.functions: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
        self._funcs_by_module: Dict[str, Dict[str, Tuple[ModuleInfo, ast.AST]]] = {}
        for mod in modules:
            mod_name = module_dotted_name(mod.path)
            local: Dict[str, ClassModel] = {}
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                qual = (f"{mod_name}.{node.name}" if mod_name
                        else f"{mod.path}::{node.name}")
                cm = ClassModel(mod, node, qual)
                self.classes[qual] = cm
                self._by_simple.setdefault(node.name, []).append(cm)
                local[node.name] = cm
            self._by_module[mod.path] = local
            flocal: Dict[str, Tuple[ModuleInfo, ast.AST]] = {}
            for node in mod.tree.body:  # top-level defs only
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fqual = (f"{mod_name}.{node.name}" if mod_name
                             else f"{mod.path}::{node.name}")
                    self.functions[fqual] = (mod, node)
                    flocal[node.name] = (mod, node)
            self._funcs_by_module[mod.path] = flocal
        for _ in range(2):  # pass 2 sees pass 1's attr/return models
            for mod in modules:
                self._infer_module(mod)

    # ----------------------------------------------------- class lookup
    def resolve_class(self, mod: ModuleInfo,
                      node: ast.AST) -> Optional[ClassModel]:
        """The :class:`ClassModel` a Name/Attribute refers to, through
        ``mod``'s import aliases; same-module classes win, then the
        alias-qualified registry, then a unique simple-name match."""
        dn = dotted_name(node)
        if dn is not None and dn in self._by_module.get(mod.path, {}):
            return self._by_module[mod.path][dn]
        resolved = mod.resolve(node)
        if resolved is None:
            return None
        if resolved in self.classes:
            return self.classes[resolved]
        simple = resolved.split(".")[-1]
        cands = self._by_simple.get(simple, [])
        return cands[0] if len(cands) == 1 else None

    def class_named(self, qualname: str) -> Optional[ClassModel]:
        return self.classes.get(qualname)

    def resolve_function(self, mod: ModuleInfo,
                         node: ast.AST) -> Optional[str]:
        """Qualified name of the module-level function a call target
        refers to (same-module def, then alias-resolved registry)."""
        dn = dotted_name(node)
        if dn is not None and dn in self._funcs_by_module.get(mod.path, {}):
            m, _fn = self._funcs_by_module[mod.path][dn]
            name = module_dotted_name(m.path)
            return (f"{name}.{dn}" if name else f"{m.path}::{dn}")
        resolved = mod.resolve(node)
        if resolved is not None and resolved in self.functions:
            return resolved
        return None

    def function_named(self, qualname: str
                       ) -> Optional[Tuple[ModuleInfo, ast.AST]]:
        return self.functions.get(qualname)

    def owner_class(self, mod: ModuleInfo,
                    fn: ast.AST) -> Optional[ClassModel]:
        """The ClassModel whose body directly holds ``fn``, else None."""
        p = mod.parents.get(fn)
        while p is not None:
            if isinstance(p, ast.ClassDef):
                for cm in self._by_module.get(mod.path, {}).values():
                    if cm.node is p:
                        return cm
                return None
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None  # a def nested in a def has no `self` model
            p = mod.parents.get(p)
        return None

    # --------------------------------------------------- type inference
    def _infer_module(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._infer_function(mod, node)

    def expr_type(self, mod: ModuleInfo, owner: Optional[ClassModel],
                  env: Dict[str, str], expr: ast.AST) -> Optional[str]:
        """Qualified class name ``expr`` evaluates to, where inferable:
        constructor calls (scanned classes AND the
        :data:`KNOWN_EXTERNAL_TYPES` like ``threading.Thread``), typed
        locals, ``self.<attr>`` through the class attribute model, and
        builder-method returns."""
        if isinstance(expr, ast.Call):
            cm = self.resolve_class(mod, expr.func)
            if cm is not None:
                return cm.qualname
            resolved = mod.resolve(expr.func)
            if resolved in KNOWN_EXTERNAL_TYPES:
                return resolved
            # builder call: self.make_x(...) with a known return type
            callee = expr.func
            if (owner is not None and isinstance(callee, ast.Attribute)
                    and isinstance(callee.value, ast.Name)
                    and callee.value.id == "self"):
                return owner.return_types.get(callee.attr)
            return None
        if isinstance(expr, ast.Name):
            if expr.id == "self" and owner is not None:
                return owner.qualname
            return env.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = self.expr_type(mod, owner, env, expr.value)
            if base is not None:
                cm = self.classes.get(base)
                if cm is not None:
                    return cm.attr_types.get(expr.attr)
        return None

    def local_env(self, mod: ModuleInfo, fn: ast.AST) -> Dict[str, str]:
        """Inferred local-variable types for one function body (a fresh
        forward pass; class models are already fixed by construction)."""
        return self._infer_function(mod, fn, record=False)

    def _infer_function(self, mod: ModuleInfo, fn: ast.AST,
                        record: bool = True) -> Dict[str, str]:
        owner = self.owner_class(mod, fn)
        env: Dict[str, str] = {}
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target = stmt.targets[0]
                t = self.expr_type(mod, owner, env, stmt.value)
                if t is None:
                    continue
                if isinstance(target, ast.Name):
                    env[target.id] = t
                elif record and isinstance(target, ast.Attribute) \
                        and isinstance(target.value, ast.Name):
                    if target.value.id == "self" and owner is not None:
                        owner.attr_types[target.attr] = t
                    else:
                        base = env.get(target.value.id)
                        cm = self.classes.get(base) if base else None
                        if cm is not None:
                            cm.attr_types[target.attr] = t
            elif record and isinstance(stmt, ast.Return) \
                    and stmt.value is not None and owner is not None \
                    and mod.enclosing_function(stmt) is fn:
                t = self.expr_type(mod, owner, env, stmt.value)
                if t is not None and isinstance(
                        fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    owner.return_types.setdefault(fn.name, t)
        return env


# ------------------------------------------------------------ loop utilities

#: the port's step naming convention (``train_step``, ``multi_step``,
#: ``step``) — shared by the step-loop rules (R7, R9)
STEP_CALL_RE = re.compile(r"^\w*step(_fn)?$")


def loop_body_calls(mod: ModuleInfo, loop: ast.AST) -> List[ast.Call]:
    """Calls lexically inside ``loop``'s body.  Bodies of functions DEFINED
    inside the loop are excluded (they do not run per iteration of this
    loop; their own loops are judged separately); nested loops' bodies are
    included (still per-iteration work)."""
    body = list(loop.body) + list(getattr(loop, "orelse", []))
    nested = {n for stmt in body for n in ast.walk(stmt)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda))}

    def under_nested(node: ast.AST) -> bool:
        p = mod.parents.get(node)
        while p is not None and p is not loop:
            if p in nested:
                return True
            p = mod.parents.get(p)
        return False

    return [n for stmt in body for n in ast.walk(stmt)
            if isinstance(n, ast.Call) and not under_nested(n)]


#: a step's builder (``build_train_step``, ``make_parallel_train_step``)
#: makes a step; it runs none
_STEP_BUILDER_RE = re.compile(r"^(build|make)_\w*$")


def is_step_call(call: ast.Call) -> bool:
    """Does this call run a train step, by the naming convention?"""
    name = dotted_name(call.func)
    if not name:
        return False
    last = name.split(".")[-1]
    return bool(STEP_CALL_RE.fullmatch(last)) \
        and not _STEP_BUILDER_RE.fullmatch(last)


# -------------------------------------------------------------------- registry

#: rule suites the CLI can select (``--suite``): the per-file tracing
#: rules (R*: capture and device hazards), the whole-program concurrency
#: analyses (T*), and the resource-lifecycle analyses (L*)
SUITES = ("tracing", "concurrency", "lifecycle")


class Rule:
    """Base class: subclasses set ``rule_id``/``name``/``hint`` and yield
    :class:`Finding` from :meth:`check`."""

    rule_id: str = ""
    name: str = ""
    #: one-line generic fix hint; rules may emit per-finding hints instead
    hint: str = ""
    #: which ``--suite`` selects this rule
    suite: str = "tracing"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(self.rule_id, mod.path, line, col, message,
                       hint if hint is not None else self.hint,
                       mod.snippet(line))


class ProgramRule(Rule):
    """A rule that needs the whole program at once (the concurrency
    suite).  Subclasses implement :meth:`check_program`; the per-module
    :meth:`check` is intentionally inert so the registry can hold both
    kinds."""

    suite = "concurrency"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        return iter(())

    def check_program(self, prog: ProgramInfo) -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and index a rule by its ``rule_id``."""
    inst = cls()
    if not inst.rule_id:
        raise ValueError(f"{cls.__name__} has no rule_id")
    _REGISTRY[inst.rule_id] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    # import side effect: rule modules self-register on first use
    from pdnlp_tpu_torch.analysis import rules  # noqa: F401
    from pdnlp_tpu_torch.analysis import concurrency  # noqa: F401
    from pdnlp_tpu_torch.analysis import lifecycle  # noqa: F401
    return dict(sorted(_REGISTRY.items()))


def select_rules(rule_ids: Optional[List[str]] = None,
                 suite: str = "all") -> Dict[str, Rule]:
    """The registry filtered by suite then by explicit ids."""
    rules = all_rules()
    if suite != "all":
        rules = {rid: r for rid, r in rules.items() if r.suite == suite}
    if rule_ids:
        rules = {rid: r for rid, r in rules.items() if rid in rule_ids}
    return rules


def run_rules(mod: ModuleInfo, rule_ids: Optional[List[str]] = None,
              suite: str = "all") -> List[Finding]:
    """All non-suppressed per-module findings for one module, sorted by
    location (program rules run separately via :func:`run_program_rules`)."""
    findings: Set[Finding] = set()  # set: nested captured defs are walked from
    for rule in select_rules(rule_ids, suite).values():  # both scopes and
        if isinstance(rule, ProgramRule):                # would double-report
            continue
        for f in rule.check(mod):
            if not mod.suppressions.is_suppressed(f.line, f.rule_id):
                findings.add(f)
    return sorted(findings, key=Finding.sort_key)


def run_program_rules(prog: "ProgramInfo",
                      rule_ids: Optional[List[str]] = None,
                      suite: str = "all") -> List[Finding]:
    """All non-suppressed whole-program findings, sorted by location.
    Suppressions apply per finding against the module the finding lands
    in — the same inline ``# torchlint: disable=`` contract as the per-file
    rules."""
    findings: Set[Finding] = set()
    for rule in select_rules(rule_ids, suite).values():
        if not isinstance(rule, ProgramRule):
            continue
        for f in rule.check_program(prog):
            mod = prog.modules.get(f.path)
            if mod is not None and \
                    mod.suppressions.is_suppressed(f.line, f.rule_id):
                continue
            findings.add(f)
    return sorted(findings, key=Finding.sort_key)
