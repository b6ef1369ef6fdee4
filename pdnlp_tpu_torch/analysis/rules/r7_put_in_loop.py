"""R7 — per-step host->device uploads inside a step loop.

A ``.to(device)`` / ``.cuda()`` / ``to_device(batch, device)`` /
``Trainer.put(batch)`` issued in the same loop that runs a train step
pays host->device transport EVERY iteration, serialized with the step's
launches — the transport tax the input pipelines
(``pdnlp_tpu_torch.data.pipeline``) exist to remove: hold the encoded
split resident on the card (no bytes per step) or upload the next batch
on a side stream while the step runs.

Heuristic, per lexical ``for``/``while`` loop: the loop's own body (not
a loop nested in it: an upload before an inner loop of steps feeds them
all, once) contains BOTH

- an upload call — a ``.cuda()`` method call, a ``.to(...)`` whose target
  is a device (a ``device``-named value, ``torch.device(...)``, a
  ``"cuda..."`` string, or ``device=``; not a dtype), or a function or
  method named ``to_device`` / ``put`` / ``put_fused`` (queue puts are
  exempted by receiver name: ``q.put(item)`` is host plumbing);
- a step call — a call whose name's last segment ends in ``step`` or
  ``step_fn`` (``train_step``, ``self.multi_step``, ``step``).

Comprehensions are NOT loops here: ``[put(b) for b in loader]`` staged
before a separate step pass is the fix, not the hazard.  The finding
lands on the upload call.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, dotted_name, is_step_call, loop_body_calls,
    register,
)

_PUT_NAME_RE = re.compile(r"^(put(_fused)?|to_device)$")
_DEVICE_NAME_RE = re.compile(r"(^|_|\.)(device|dev)$", re.IGNORECASE)
_QUEUE_RECV_RE = re.compile(r"^(q|queue|.*_q|.*queue)$", re.IGNORECASE)


@register
class PutInStepLoop(Rule):
    rule_id = "R7"
    name = "device-put-in-step-loop"
    hint = ("move the upload out of the step loop: route batches through "
            "pdnlp_tpu_torch.data.pipeline (a resident split = no "
            "steady-state transport; the prefetch pipeline = the upload "
            "of batch k+1 overlaps step k), or upload the batches before "
            "the loop")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return  # pure-host module: its puts are not device transport
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            # per step: the upload and a step in this loop's own body (an
            # upload before an inner loop of steps feeds them all once)
            calls = [c for c in loop_body_calls(mod, loop)
                     if self._innermost_loop(mod, c) is loop]
            if not any(is_step_call(c) for c in calls):
                continue
            for c in calls:
                if self._is_put_call(mod, c):
                    yield self.finding(
                        mod, c,
                        "host->device upload inside a loop that runs a "
                        "train step — every iteration pays transport "
                        "serially with the step")

    @staticmethod
    def _innermost_loop(mod: ModuleInfo, node: ast.AST):
        p = mod.parents.get(node)
        while p is not None and not isinstance(p, (ast.For, ast.While)):
            p = mod.parents.get(p)
        return p

    def _is_put_call(self, mod: ModuleInfo, call: ast.Call) -> bool:
        if isinstance(call.func, ast.Attribute):
            if call.func.attr == "cuda":
                return True
            if call.func.attr == "to" and self._to_device(mod, call):
                return True
        name = dotted_name(call.func)
        if not name:
            return False
        parts = name.split(".")
        if not _PUT_NAME_RE.fullmatch(parts[-1]):
            return False
        # q.put(item) / out_queue.put(x): host plumbing, not transport
        if len(parts) > 1 and _QUEUE_RECV_RE.fullmatch(parts[-2]):
            return False
        return True

    @staticmethod
    def _to_device(mod: ModuleInfo, call: ast.Call) -> bool:
        """``.to(<a device>)``: a device-named value, ``torch.device(...)``,
        a ``"cuda..."`` string, or a ``device=`` keyword."""
        if any(k.arg == "device" for k in call.keywords):
            return True
        if not call.args:
            return False
        t = call.args[0]
        if isinstance(t, ast.Constant):
            return isinstance(t.value, str) and t.value.startswith("cuda")
        if isinstance(t, ast.Call):
            return mod.resolve(t.func) == "torch.device"
        return bool(_DEVICE_NAME_RE.search(dotted_name(t) or ""))
