"""L3: checkpoint/manifest writes must use the atomic publish protocol.

``train.checkpoint`` publishes every durable artifact the same way:
write to ``path + ".tmp"``, flush, fsync, ``os.replace`` into place
(``_atomic_write_bytes`` / ``write_json_atomic`` / ``publish``).  A
reader — the fleet watcher, a resume, a human — can then never observe
a torn file.  L3 flags direct writes that bypass the protocol on paths
that look like watched publish artifacts.

Scope is deliberately conservative (this rule must not bury the repo's
plain results/log writers in noise): a write is only judged when its
path expression *textually* looks watched — mentions ``ckpt`` /
``checkpoint`` / ``manifest`` / ``.msgpack`` / ``best.json`` /
``publish`` — and is only sanctioned when the SAME function hands the
written path to ``os.replace``/``os.rename`` (the tmp half of the
protocol) or delegates to one of the sanctioned writers.  Extend
:data:`WATCHED_PATH_RE` to put more artifacts under the contract.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional, Set

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register
from pdnlp_tpu_torch.analysis.lifecycle.model import expr_text

#: path expressions that are "watched": publish artifacts someone else
#: reads concurrently.  The extension point for new artifact families.
WATCHED_PATH_RE = re.compile(
    r"ckpt|checkpoint|manifest|\.msgpack|best\.json|best_json|publish",
    re.IGNORECASE)

#: callables that already implement (or ride) the atomic protocol
_SANCTIONED_WRITERS = {
    "write_json_atomic", "_atomic_write_bytes", "publish", "submit_json",
}

_WRITE_MODES = ("w", "a", "x")


def _open_write_path(call: ast.Call) -> Optional[ast.AST]:
    """The path argument when ``call`` is ``open(path, "w"/"wb"/...)``."""
    f = call.func
    if not (isinstance(f, ast.Name) and f.id == "open"):
        return None
    if not call.args:
        return None
    mode: Optional[str] = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            mode = kw.value.value
    if mode is None or not mode.startswith(_WRITE_MODES):
        return None
    return call.args[0]


@register
class NonAtomicPublish(Rule):
    rule_id = "L3"
    name = "non-atomic-publish"
    suite = "lifecycle"
    hint = ("publish watched artifacts crash-atomically: "
            "checkpoint.write_json_atomic(path, obj), or write to "
            "path+'.tmp', flush+fsync, then os.replace(tmp, path)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if "open(" not in mod.source:
            return
        for name, fn, body in mod.scopes():
            if isinstance(fn, ast.Lambda):
                continue
            yield from self._check_scope(mod, fn, body)

    def _check_scope(self, mod: ModuleInfo, fn: ast.AST,
                     body: List[ast.stmt]) -> Iterator[Finding]:
        nested = {n for stmt in body for n in ast.walk(stmt)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.Lambda)) and n is not fn}

        def in_nested(node: ast.AST) -> bool:
            p = mod.parents.get(node)
            while p is not None and p is not fn:
                if p in nested:
                    return True
                p = mod.parents.get(p)
            return False

        calls = [n for stmt in body for n in ast.walk(stmt)
                 if isinstance(n, ast.Call) and not in_nested(n)]

        # the tmp half of the protocol: paths handed to os.replace/rename
        replaced: Set[str] = set()
        for c in calls:
            if mod.resolve(c.func) in ("os.replace", "os.rename") and c.args:
                replaced.add(expr_text(c.args[0]))

        # local name -> the expression it was assigned from (one hop),
        # so `p = dir + "/ckpt.msgpack"; open(p, "w")` is judged by the
        # RHS text too
        assigned: dict = {}
        for stmt in body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name):
                    assigned[n.targets[0].id] = n.value

        def path_text(path_expr: ast.AST) -> str:
            text = expr_text(path_expr)
            if isinstance(path_expr, ast.Name) and \
                    path_expr.id in assigned:
                text += " " + expr_text(assigned[path_expr.id])
            return text

        for c in calls:
            path_expr = _open_write_path(c)
            if path_expr is None:
                continue
            text = path_text(path_expr)
            if not WATCHED_PATH_RE.search(text):
                continue
            if expr_text(path_expr) in replaced:
                continue  # tmp file later os.replace'd: the protocol
            if isinstance(path_expr, ast.Name) and \
                    path_expr.id in assigned and \
                    expr_text(assigned[path_expr.id]) in replaced:
                continue
            fname = getattr(fn, "name", "<module>")
            if fname in _SANCTIONED_WRITERS:
                continue
            yield self.finding(
                mod, c,
                f"watched artifact written non-atomically "
                f"(open({expr_text(path_expr)!r}, write mode) with no "
                "os.replace of that path in this function)")
