"""R17 — a speculation dispatch whose shape follows the runtime k.

Speculative decoding (``pdnlp_tpu_torch.serve.decode``: draft k, verify
once) stays free of recaptures by construction: the drafter runs k
fixed-shape ``[slots, 1]`` decode steps and the primary scores all k + 1
positions in ONE ``verify`` program of fixed ``[slots, k + 1]`` extent —
the count of real positions rides a data argument (``nreal``), never the
tensor's shape.  The engine keys the program ``("verify", slots, k + 1)``
(``PagedDecodeEngine.verify_ids``) and warms one graph per configured k
(``warmup_verify``).  The tempting spelling inverts that::

    for _ in range(max_new):
        window = draft(model, tok, kv)
        logits = engine.verify_ids(window[:, : a + 1], pos, nreal, live)
        a = accept_len(logits, window)                       # ^ R17

Slicing the verify window to the accepted length (or the draft window to
an adaptive k) gives ``_program`` a new key whenever the acceptance
changes — under greedy speculation nearly every round — so it captures
one CUDA graph per acceptance length and the fast path serves slower than
the loop it was meant to beat.

Heuristic, per lexical ``for`` / ``while`` loop (R16's): the loop is
DECODE-SHAPED — it calls something whose name's last segment contains
``decode`` / ``prefill`` / ``generate`` / ``draft`` / ``verify`` /
``speculat`` or is step-shaped — and its body calls a SPECULATION
dispatch (``draft`` / ``verify`` / ``speculat`` in the last segment) with
an argument sliced by a bound that names a value (``window[:, : a + 1]``,
``tok[:, :k]``).  Full-width dispatch, literal bounds, the runtime length
passed as data, and a variable slice outside a decode loop never match.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, call_last_name, has_runtime_slice,
    is_step_call, loop_body_calls, register,
)

_DECODE_CALL_RE = re.compile(
    r"(decode|prefill|generate|draft|verify|speculat)", re.I)
_SPEC_CALL_RE = re.compile(r"(draft|verify|speculat)", re.I)


@register
class PerKRetraceInSpeculation(Rule):
    rule_id = "R17"
    name = "per-k-retrace-in-speculation"
    hint = ("dispatch the draft/verify program at its FULL fixed width "
            "([slots, k+1] for one configured k) and pass the runtime "
            "accepted or real length as a data argument the program masks "
            "on (pdnlp_tpu_torch.serve.decode PagedDecodeEngine.verify_ids"
            " keys ('verify', slots, k+1) and warmup_verify captures it "
            "once per k) — slicing the window to a runtime length inside "
            "the decode loop gives the program a new shape nearly every "
            "round, so it captures one graph per acceptance length")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            calls = loop_body_calls(mod, loop)
            if not any(_DECODE_CALL_RE.search(call_last_name(c))
                       or is_step_call(c) for c in calls):
                continue
            for c in calls:
                if _SPEC_CALL_RE.search(call_last_name(c)) \
                        and has_runtime_slice(c):
                    yield self.finding(
                        mod, c,
                        "speculation dispatch sliced to a runtime length "
                        "inside a decode loop — every distinct accepted "
                        "length (or adapted k) is a new program shape, so "
                        "the verify/draft graph is captured per round "
                        "instead of once per configured k with the real "
                        "length passed as masked data")
