"""R12 — device tensors in span and record attributes.

The tracer keeps instrumentation off the device stream: spans measure host
windows, and device time surfaces only through ``Tracer.block``'s own
``device_block`` span (:mod:`pdnlp_tpu_torch.obs.trace`).  A tensor the
step or forward produced, passed as a span or record ATTRIBUTE, breaks
that from the side door:

- ``tracer.span("log", loss=metrics["loss"])`` keeps a live CUDA tensor
  in the ring — serializing it (flush, listeners) syncs at some later
  point inside someone else's measured window, and the ring pins the
  tensor's memory;
- ``tracer.span("log", loss=float(metrics["loss"]))`` syncs right there,
  at the instrumentation site in the hot loop — the smearing the
  dispatch / ``device_block`` split exists to avoid.

The sanctioned shape reads the value at the loop's own barrier and passes
the host number, which is why an explicit sync at the top of an
assignment LAUNDERS: a name assigned from ``float(...)``, ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()`` or ``np.asarray(...)`` holds host
data, and attaching it to a later span is right.

Heuristic, per scope, in modules that import torch: names assigned from a
dispatch-shaped call (R10's: ``forward`` / ``replay`` / ``program`` in the
name, or step-shaped — tuple targets included) hold device values, and so
does any name assigned from an expression that reads one (metadata reads —
``.shape``, ``.size()``, ``len()`` — do not propagate; an explicit sync
launders).  A keyword attribute of ``<x>.span(...)`` or
``<x>.record(...)`` whose expression reads a device value is flagged;
``**attrs`` spreads are out of reach.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Set

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, call_last_name, register,
)
from pdnlp_tpu_torch.analysis.rules.r10_unspanned_serve_block import (
    dispatch_shaped,
)

#: calls whose RESULT is host data even when fed a tensor — the sync
#: happened there, at the caller's chosen point, not inside the tracer
_SYNC_CALLS = {"float", "int", "bool", "numpy.asarray", "numpy.array"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _targets(node: ast.AST) -> Iterator[str]:
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)
    elif isinstance(node, ast.Starred):
        yield from _targets(node.value)


@register
class DeviceValueInSpanAttr(Rule):
    rule_id = "R12"
    name = "device-value-in-span-attr"
    hint = ("span/record attrs must be host values: read the tensor at "
            "the loop's barrier first (`loss = float(metrics['loss'])` "
            "after Tracer.block or the step's own sync) and pass THAT — a "
            "tensor in the attr syncs inside the instrumented region (or "
            "pins device memory in the trace ring), smearing device time "
            "the dispatch/device_block split exists to separate "
            "(pdnlp_tpu_torch.obs.trace)")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return  # a host module: nothing here is a device value
        for _, scope, _ in mod.scopes():
            own = mod.own_nodes(scope)
            if any(isinstance(n, ast.Call)
                   and dispatch_shaped(call_last_name(n)) for n in own):
                yield from self._check_scope(mod, own)

    @staticmethod
    def _laundered(mod: ModuleInfo, value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        if mod.resolves_to(value.func, _SYNC_CALLS):
            return True
        return isinstance(value.func, ast.Attribute) \
            and value.func.attr in _SYNC_METHODS

    def _device_names(self, mod: ModuleInfo, own: List[ast.AST]
                      ) -> Set[str]:
        device: Set[str] = set()
        grew = True
        while grew:
            grew = False
            for node in own:
                if isinstance(node, ast.Assign):
                    pairs = [(t, node.value) for t in node.targets]
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                                       ast.NamedExpr)) \
                        and getattr(node, "value", None) is not None:
                    pairs = [(node.target, node.value)]
                else:
                    continue
                for target, value in pairs:
                    hot = (isinstance(value, ast.Call)
                           and dispatch_shaped(call_last_name(value))) or (
                        not self._laundered(mod, value)
                        and mod.reads_tensor(value, device))
                    if not hot:
                        continue
                    for name in _targets(target):
                        if name not in device:
                            device.add(name)
                            grew = True
        return device

    def _check_scope(self, mod: ModuleInfo, own: List[ast.AST]
                     ) -> Iterator[Finding]:
        device = self._device_names(mod, own)
        if not device:
            return
        for node in own:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "record")):
                continue
            for kw in node.keywords:
                if kw.arg is not None \
                        and mod.reads_tensor(kw.value, device):
                    yield self.finding(
                        mod, kw.value,
                        f"span/record attr {kw.arg!r} is a device tensor "
                        "— it syncs inside the instrumented region (or "
                        "pins device memory in the trace ring)")
