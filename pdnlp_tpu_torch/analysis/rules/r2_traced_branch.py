"""R2 — Python control flow on tensor values inside a captured region.

An ``if`` / ``while`` / ``assert`` on a tensor's value inside a capture
reads the value on the host (a sync, illegal while the stream captures),
or — where the test is decided on a value the capture run held — bakes
that ONE branch into the graph: every replay takes it, whatever the
tensor holds then.  Host metadata reads (``x.shape``, ``x.size(0)``,
``x.dim()``, ``len(x)``, ``x is None``, ``"k" in batch``) are fine and
not flagged.
"""
from __future__ import annotations

import ast
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register

_KIND = {ast.If: "if", ast.While: "while", ast.Assert: "assert"}

_HINTS = {
    "if": "compute both sides and select with torch.where (or decide "
          "the branch from host state before the capture)",
    "while": "unroll to a fixed count known before the capture",
    "assert": "check after the replay (or with a device-side flag the "
              "host reads after a sync); an assert on a tensor inside "
              "the graph runs once, at capture",
}


@register
class TensorBranchInCapture(Rule):
    rule_id = "R2"
    name = "tensor-branch-in-capture"
    hint = "replace Python control flow on a tensor with device selects"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for region, body in mod.captured_regions():
            tainted = mod.region_taint(region)
            for stmt in body:
                for node in ast.walk(stmt):
                    kind = _KIND.get(type(node))
                    if kind is None:
                        continue
                    if mod.reads_tensor(node.test, tainted):
                        yield self.finding(
                            mod, node,
                            f"Python `{kind}` on a tensor's value inside a "
                            "captured region — a host sync, or one branch "
                            "baked into every replay",
                            _HINTS[kind])
