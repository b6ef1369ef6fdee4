"""R10 — serve dispatch paths that block on device results outside a span.

Every point where the serving path waits for the card lives inside a
tracer span: the ``forward`` / ``compile`` / ``decode`` / ``handoff``
vocabulary is what lets ``python -m pdnlp_tpu_torch.tools.trace
summarize`` build per-replica phase tables and the trace diff catch
latency regressions.  The engine's shape is ``serve/engine.py``
``_execute``: the span opens around ``_replay``, which replays the graph
and synchronizes its stream inside.  A dispatch path that reads a forward's
output on the host (``.cpu()``, ``.item()``, ``float()``) or synchronizes
the card outside any span hides the device wait — the router looks fast
while a replica's stream is the bottleneck.

Heuristic, per scope, in serve modules (a module under
``pdnlp_tpu_torch/serve/`` or one that imports from it; ``chip_smoke.py``):

- a *dispatch-shaped* value is assigned from a call whose name contains
  ``forward``, ``replay`` or ``program``, or is step-shaped
  (``core.STEP_CALL_RE``: ``decode_step``, ``paged_verify_step``; not a
  builder, ``build_train_step``);
- a blocking read of one — ``.cpu()``, ``.numpy()``, ``.item()``,
  ``.tolist()`` on it, ``float()`` / ``int()`` of it, or the same on an
  inline dispatch call — is flagged;
- so is ``torch.cuda.synchronize()`` or a stream's or event's
  ``.synchronize()`` as the statement right after one that dispatches
  (the wait for that dispatch) — unless the next statement reads a host
  timer: a sync that closes a timing window is R4's barrier;

unless the read is lexically inside a ``with <tracer>.span(...)`` block,
or its function is *spanned*: every call of it in the module (by name or
on ``self``) is inside a span or inside another spanned function — the
engine's ``_replay`` and the decoder's ``_eager`` are spanned by their one
caller.  ``Tracer.block`` needs no exemption: it holds the barrier itself.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, call_last_name, is_step_name, register,
)
from pdnlp_tpu_torch.analysis.rules.r4_timing import _TIMERS

#: method reads that copy to the host or wait for the card
_READ_METHODS = {"cpu", "numpy", "item", "tolist"}
_SYNC_CALLS = {"torch.cuda.synchronize"}


def dispatch_shaped(name: str) -> bool:
    """A call that runs the device program (R10, R12)."""
    low = name.lower()
    return any(w in low for w in ("forward", "replay", "program")) \
        or is_step_name(name)


def _is_dispatch_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) \
        and dispatch_shaped(call_last_name(node))


def spanned_functions(mod: ModuleInfo) -> Set[ast.AST]:
    """Defs whose every call in the module runs under a span (directly or
    through another such def); a def with no call here is not."""
    defs: Dict[str, List[ast.AST]] = {}
    for n in ast.walk(mod.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(n.name, []).append(n)
    sites: Dict[str, List[ast.Call]] = {}
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Call):
            f = n.func
            name = f.id if isinstance(f, ast.Name) else f.attr \
                if isinstance(f, ast.Attribute) and isinstance(
                    f.value, ast.Name) and f.value.id == "self" else None
            if name in defs:
                sites.setdefault(name, []).append(n)
    spanned: Set[ast.AST] = set()
    grew = True
    while grew:
        grew = False
        for name, calls in sites.items():
            if defs[name][0] in spanned:
                continue
            if all(mod.inside_span(c) or any(
                    f in spanned for f in _enclosing_defs(mod, c))
                    for c in calls):
                spanned.update(defs[name])
                grew = True
    return spanned


def _enclosing_defs(mod: ModuleInfo, node: ast.AST) -> Iterator[ast.AST]:
    fn = mod.enclosing_function(node)
    while fn is not None:
        yield fn
        fn = mod.enclosing_function(fn)


@register
class UnspannedServeBlock(Rule):
    rule_id = "R10"
    name = "unspanned-serve-block"
    hint = ("read the result inside the dispatch's tracer span — `with "
            "engine.tracer.span('forward', ...): out = run(...).cpu()` — "
            "or synchronize inside a function only a span calls (the "
            "engine's _execute -> _replay shape), or hand the tensor to "
            "`Tracer.block(out)` so the wait lands in its own device_block "
            "span (pdnlp_tpu_torch.obs.trace); the serve dispatch path "
            "must never wait for the card invisibly")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_serve_scope():
            return
        spanned = None
        for _, scope, _ in mod.scopes():
            own = mod.own_nodes(scope)
            found = list(self._check_scope(mod, own))
            if not found:
                continue
            if spanned is None:
                spanned = spanned_functions(mod)
            if any(f in spanned for f in [scope]
                   + list(_enclosing_defs(mod, scope))):
                continue
            yield from found

    def _check_scope(self, mod: ModuleInfo, own: List[ast.AST]
                     ) -> Iterator[Finding]:
        dispatch: Set[str] = set()
        for node in own:
            if isinstance(node, ast.Assign) and _is_dispatch_call(node.value):
                for t in node.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            dispatch.add(n.id)
        lines: Set[int] = set()   # `.cpu().numpy()` reports once
        for node in own:
            if not isinstance(node, ast.Call) or node.lineno in lines:
                continue
            if self._reads_dispatch(node, dispatch):
                if mod.inside_span(node):
                    continue
                lines.add(node.lineno)
                yield self.finding(
                    mod, node,
                    "serve dispatch path reads device results on the host "
                    "outside any tracer span — the device wait is "
                    "invisible to the per-replica phase tables and the "
                    "trace diff")
            elif self._is_sync(mod, node) and self._after_dispatch(
                    mod, node) and not mod.inside_span(node):
                lines.add(node.lineno)
                yield self.finding(
                    mod, node,
                    "serve dispatch path synchronizes the card outside "
                    "any tracer span — the device wait is invisible to "
                    "the per-replica phase tables and the trace diff")

    @staticmethod
    def _after_dispatch(mod: ModuleInfo, call: ast.Call) -> bool:
        """Is the sync its own statement, right after a statement of the
        same block that dispatches (the wait for that dispatch), and not
        right before a timer read (the close of a timing window: R4's
        barrier)?"""
        stmt = mod.parents.get(call)
        block = mod.parents.get(stmt)
        if not isinstance(stmt, ast.Expr) or block is None:
            return False
        for field in ("body", "orelse", "finalbody"):
            body = getattr(block, field, None)
            if isinstance(body, list) and stmt in body:
                i = body.index(stmt)
                timed = i + 1 < len(body) and any(
                    isinstance(n, ast.Call) and mod.resolves_to(n.func,
                                                                _TIMERS)
                    for n in ast.walk(body[i + 1]))
                return i > 0 and not timed and any(
                    _is_dispatch_call(n) for n in ast.walk(body[i - 1]))
        return False

    @staticmethod
    def _is_sync(mod: ModuleInfo, call: ast.Call) -> bool:
        if mod.resolves_to(call.func, _SYNC_CALLS):
            return True
        return isinstance(call.func, ast.Attribute) \
            and call.func.attr == "synchronize" and not call.args

    @staticmethod
    def _reads_dispatch(call: ast.Call, dispatch: Set[str]) -> bool:
        """A host read whose operand is (or holds) a dispatch result."""
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _READ_METHODS and not call.args:
            operands = [call.func.value]
        elif isinstance(call.func, ast.Name) \
                and call.func.id in ("float", "int") and call.args:
            operands = [call.args[0]]
        else:
            return False
        for arg in operands:
            for n in ast.walk(arg):
                if isinstance(n, ast.Name) and n.id in dispatch:
                    return True
                if _is_dispatch_call(n):
                    return True
        return False
