"""R9 — synchronous checkpoint writes inside a step loop.

A ``torch.save`` or ``checkpoint.save*`` call in the same loop that runs a
train step copies the whole train state to the host, serializes it and
writes + fsyncs it before the next step can even be launched — the step
loop stalls on host CPU and disk for work that has no ordering dependency
on it beyond the device->host snapshot.  The port's async checkpointer
(``pdnlp_tpu_torch.train.async_ckpt``) splits the save at exactly that
line: the loop pays the snapshot, a writer thread pays serialization and
the crash-atomic publish, with at most one save in flight.

Heuristic, per lexical ``for``/``while`` loop (sharing R7's loop-body
machinery): the loop body contains BOTH

- a step call — a call whose name's last segment ends in ``step``/
  ``step_fn``;
- a synchronous checkpoint write — ``torch.save``, a call resolving to
  ``pdnlp_tpu_torch.train.checkpoint.save``/``save_state``/``save_params``
  (through import aliases), or any call whose last name segment is
  ``save_state``/``save_params``/``save_resume``/``save_checkpoint``/
  ``save_ckpt`` (``self.save_resume(...)``, the trainer convention).

``AsyncCheckpointer.submit`` and ``checkpoint.snapshot`` deliberately do
NOT match: snapshot-in-loop + submit IS the fix.  The finding lands on the
save call.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, dotted_name, is_step_call, loop_body_calls,
    register,
)

_CKPT_SAVE_FUNCS = {
    "torch.save",
    "pdnlp_tpu_torch.train.checkpoint.save",
    "pdnlp_tpu_torch.train.checkpoint.save_state",
    "pdnlp_tpu_torch.train.checkpoint.save_params",
}
_SAVE_NAME_RE = re.compile(r"^save_(state|params|resume|checkpoint|ckpt)$")


@register
class BlockingCkptInStepLoop(Rule):
    rule_id = "R9"
    name = "blocking-ckpt-in-step-loop"
    hint = ("keep only the device->host snapshot on the step loop: route "
            "the write through pdnlp_tpu_torch.train.async_ckpt — the "
            "writer thread pays serialization and the crash-atomic "
            "publish (at most one save in flight, the step loop never "
            "blocks on disk)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not self._relevant(mod):
            return
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            calls = loop_body_calls(mod, loop)
            if not any(is_step_call(c) for c in calls):
                continue
            for c in calls:
                if self._is_sync_save(mod, c):
                    yield self.finding(
                        mod, c,
                        "synchronous checkpoint write inside a loop that "
                        "runs a train step — the loop blocks on "
                        "serialization + disk every save instead of "
                        "paying the device->host snapshot only")

    @staticmethod
    def _relevant(mod: ModuleInfo) -> bool:
        """Train-loop-shaped modules only: the file must touch torch or the
        checkpoint module — a pure-host script's ``save_*`` helpers are
        not device-loop stalls."""
        return mod.imports_torch() or any(
            a.startswith("pdnlp_tpu_torch.train.checkpoint")
            for a in mod.aliases.values())

    def _is_sync_save(self, mod: ModuleInfo, call: ast.Call) -> bool:
        if mod.resolves_to(call.func, _CKPT_SAVE_FUNCS):
            return True
        name = dotted_name(call.func)
        if not name:
            return False
        return bool(_SAVE_NAME_RE.fullmatch(name.split(".")[-1]))
