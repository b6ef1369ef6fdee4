"""R4 — timing windows around CUDA work with no completion barrier.

CUDA launches are asynchronous: a step, a kernel or a replay returns as
soon as its work is *enqueued*.  ``t1 - t0`` around such calls measures
the launch, not the compute — the wrong wall-clock number the smoke's
``[clock]`` and step-time lines take care to avoid (they end their
windows in ``torch.cuda.synchronize()``).

Heuristic, per scope: ``t0 = time.time()`` (or ``perf_counter`` /
``monotonic`` / ``timeit.default_timer``) followed by a subtraction against
``t0``, where the statements in between contain at least one non-timer call
but NO barrier (``torch.cuda.synchronize``, an event's or stream's
``synchronize()``, an event's ``elapsed_time``, a host read —
``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` / ``float()`` /
``int()`` / ``np.asarray`` — the obs tracer's ``block``, or a function
or method of the module whose body does one of these).  A delta compared
against a limit (``time.monotonic() - t0 < 60``) is a deadline check, not
a timing, and windows in modules that never import torch time pure-host
work: both are skipped.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register

_TIMERS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "time.perf_counter_ns", "time.monotonic_ns", "timeit.default_timer",
}

_SYNC_CALLS = {
    "torch.cuda.synchronize", "numpy.asarray", "numpy.array", "float",
    "int",
}

#: method names treated as barriers.  Deliberately NOT `join`/`get`: they
#: also name str.join/dict.get, and a timing loop that merely formats a log
#: line must not be exempted by its own formatting.  `block` is the obs
#: tracer's barrier (`Span.block`/`Tracer.block` synchronizes in a
#: device_block span) — the sanctioned fix for traced timing windows;
#: `elapsed_time` reads two recorded CUDA events.
_SYNC_METHODS = {"item", "synchronize", "tolist", "numpy", "cpu", "result",
                 "block", "elapsed_time", "wait"}


@register
class UnblockedTiming(Rule):
    rule_id = "R4"
    name = "unblocked-async-timing"
    hint = ("call torch.cuda.synchronize() — or time with CUDA events and "
            "elapsed_time — before reading the second timestamp; inside "
            "an obs span, sp.block(out) records the barrier as its own "
            "device_block span (pdnlp_tpu_torch.obs.trace)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return  # pure-host module: timing it needs no device barrier
        self._barrier_helpers = self._local_barrier_helpers(mod)
        for _, scope_node, body in mod.scopes():
            yield from self._check_scope(mod, scope_node, body)

    def _local_barrier_helpers(self, mod: ModuleInfo) -> set:
        """Names of local defs whose body performs a sync — probe scripts
        wrap their completion in a helper (`_sync(torch, device)` around
        `torch.cuda.synchronize`), and calling it IS a barrier."""
        helpers = set()
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for n in ast.walk(node):
                if isinstance(n, ast.Call) and self._is_sync(mod, n,
                                                             helpers=()):
                    helpers.add(node.name)
                    break
        return helpers

    def _is_timer_call(self, mod: ModuleInfo, node: ast.AST) -> bool:
        return isinstance(node, ast.Call) \
            and mod.resolves_to(node.func, _TIMERS)

    def _check_scope(self, mod: ModuleInfo, scope_node, body
                     ) -> Iterator[Finding]:
        own = [n for stmt in body for n in ast.walk(stmt)
               if self._in_scope(mod, scope_node, n)]
        # name -> EVERY assignment line: probe scripts reuse one `t0` across
        # sequential phases, and each delta must pair with the latest
        # assignment before it, not just the final one
        timer_vars: Dict[str, List[int]] = {}
        for node in own:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and self._is_timer_call(mod, node.value):
                timer_vars.setdefault(node.targets[0].id,
                                      []).append(node.lineno)

        if not timer_vars:
            return

        calls = [n for n in own if isinstance(n, ast.Call)]
        for node in own:
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            right = node.right
            if not (isinstance(right, ast.Name) and right.id in timer_vars):
                continue
            if isinstance(mod.parents.get(node), ast.Compare):
                continue  # a deadline check (`now - t0 < 60`), not a timing
            left_ok = self._is_timer_call(mod, node.left) or (
                isinstance(node.left, ast.Name) and node.left.id in timer_vars)
            if not left_ok:
                continue
            end = node.lineno
            starts = [s for s in timer_vars[right.id] if s < end]
            if not starts:
                continue
            start = max(starts)  # the latest assignment before this delta
            window = [c for c in calls
                      if start <= c.lineno <= end
                      and not self._is_timer_call(mod, c)]
            if not window:
                continue  # nothing was dispatched in the window
            if any(self._is_sync(mod, c) for c in window):
                continue
            yield self.finding(
                mod, node,
                f"timing window (line {start} -> {end}) around launched "
                "work has no synchronize/host read — asynchronous CUDA "
                "launches make this delta measure enqueue, not compute")

    def _in_scope(self, mod: ModuleInfo, scope_node, node) -> bool:
        fn = mod.enclosing_function(node)
        if isinstance(scope_node, ast.Module):
            return fn is None
        return fn is scope_node or node is scope_node

    def _is_sync(self, mod: ModuleInfo, call: ast.Call,
                 helpers=None) -> bool:
        if mod.resolves_to(call.func, _SYNC_CALLS):
            return True
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _SYNC_METHODS:
            return True
        if helpers is None:
            helpers = getattr(self, "_barrier_helpers", ())
        # a helper called by name, or a method of the module's classes
        # (`self._sync()`, `busy._sync()`)
        name = call.func.id if isinstance(call.func, ast.Name) else (
            call.func.attr if isinstance(call.func, ast.Attribute) else None)
        return name in helpers
