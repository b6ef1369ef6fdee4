"""R1 — host syncs inside a captured region.

A CUDA graph records device work only.  Inside a capture, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``float/int/bool(tensor)``, a
blocking copy to the host (``.to("cpu")``), ``torch.cuda.synchronize``
or an event's or a stream's ``synchronize()`` either raises (a sync is
illegal while the stream captures) or — where it slips through on a value
the capture happened to hold — reads the capture run's value once and
freezes it into every replay.  The captured train step's discipline
(``train.steps._MultiStep``: the metrics stay on the card and are copied
out after the replay) exists to avoid exactly this.
"""
from __future__ import annotations

import ast
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, dotted_name, register,
)

#: canonical call targets that wait for the card or copy to the host
_HOST_CALLS = {
    "torch.cuda.synchronize": "synchronize after the replay, outside the "
                              "captured region",
    "numpy.asarray": "keep the tensor on the card inside the capture; "
                     "convert on the host after the replay",
    "numpy.array": "keep the tensor on the card inside the capture; "
                   "convert on the host after the replay",
}

#: method calls that copy a tensor to the host or wait for the card
_HOST_METHODS = {
    "item": "return the tensor and call .item() on the host after the "
            "replay",
    "tolist": "return the tensor; .tolist() belongs after the replay",
    "numpy": "return the tensor; .numpy() belongs after the replay",
    "cpu": "copy to the host after the replay (or into a pinned buffer "
           "with non_blocking=True outside the graph)",
    "synchronize": "an event's or a stream's synchronize waits on the "
                   "host: record the event in the graph and wait after "
                   "the replay",
}


def _to_host(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
    "cpu"))`` without ``non_blocking=True``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    if any(k.arg == "non_blocking" and isinstance(k.value, ast.Constant)
           and k.value.value is True for k in call.keywords):
        return False
    targets = list(call.args[:1]) + [k.value for k in call.keywords
                                     if k.arg == "device"]
    for t in targets:
        if isinstance(t, ast.Call) and t.args:
            t = t.args[0]             # torch.device("cpu")
        if isinstance(t, ast.Constant) and t.value == "cpu":
            return True
    return False


@register
class HostSyncInCapture(Rule):
    rule_id = "R1"
    name = "host-sync-in-capture"
    hint = "move the host read outside the captured region"

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        for region, body in mod.captured_regions():
            tainted = mod.region_taint(region)
            for stmt in body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        yield from self._check_call(mod, node, tainted)

    def _check_call(self, mod, node: ast.Call, tainted):
        target = mod.resolve(node.func)
        if target in _HOST_CALLS or (
                target and target.startswith("np.")
                and ("numpy." + target[3:]) in _HOST_CALLS):
            canon = target if target in _HOST_CALLS else "numpy." + target[3:]
            yield self.finding(
                mod, node,
                f"`{dotted_name(node.func)}` inside a captured region "
                "waits for the card on the host (illegal while the stream "
                "captures, or frozen into every replay)",
                _HOST_CALLS[canon])
            return
        # float(x) / int(x) / bool(x) on a tensor
        if isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "int", "bool"):
            if node.args and mod.reads_tensor(node.args[0], tainted):
                yield self.finding(
                    mod, node,
                    f"`{node.func.id}()` on a tensor inside a captured "
                    "region reads the device value on the host",
                    "keep the value a tensor (torch.where / a device "
                    "scalar); read it after the replay")
            return
        if isinstance(node.func, ast.Attribute) and not node.args \
                and node.func.attr in _HOST_METHODS:
            yield self.finding(
                mod, node,
                f"`.{node.func.attr}()` inside a captured region is a "
                "host-device sync point",
                _HOST_METHODS[node.func.attr])
            return
        if _to_host(node):
            yield self.finding(
                mod, node,
                "a blocking copy to the host inside a captured region",
                "copy after the replay, or with non_blocking=True into a "
                "pinned buffer the host reads after a sync")
