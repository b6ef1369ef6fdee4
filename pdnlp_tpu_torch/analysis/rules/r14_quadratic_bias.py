"""R14 — a quadratic ``[B, 1, S, S]`` segment or attention bias built on a
hot path.

The flash kernels (``ops/flash.py``, K1-K3) exist to avoid this tensor:
they take the ``[B, S]`` segment IDs or the ``[B, S]`` key bias and mask
on chip.  At S = 2048 one fp32 ``[B, 1, S, S]`` bias is 16 MB per batch
row per materialization — quadratic memory traffic in a layer whose inputs
are linear in S.  Building it again in a step, a forward or the model's
layers re-caps the stack at short widths, and no parity gate notices (the
math is the same, only the roofline moves).

Heuristic, in *hot-path* functions (R8's scope: step-builder- or
step-shaped names, model and serve forwards, and defs nested in them), in
modules that import torch:

- a call of ``data.packing.segment_bias`` — its one sanctioned caller is
  the plain route of ``ops/attention.py`` (``dot_product_attention``, when
  the kernel is not routed), which is exempt;
- the ID outer product ``seg[:, :, None] == seg[:, None, :]`` (any
  arrangement of the broadcast axes, the same base on both sides) — the
  expression that builds the ``[B, S, S]`` mask;
- ``torch.zeros`` / ``ones`` / ``full`` / ``empty`` or ``.expand`` whose
  literal shape ends in two equal integer dims >= 512.

The width is known statically only in the literal form; the first two are
flagged at any width — routing the IDs costs nothing at short widths
either.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register
from pdnlp_tpu_torch.analysis.rules.r8_xla_attention import _HOT_NAME_RE

_SEGMENT_BIAS = {"pdnlp_tpu_torch.data.packing.segment_bias",
                 "data.packing.segment_bias", "packing.segment_bias",
                 "segment_bias"}
_ALLOC = {"torch.zeros", "torch.ones", "torch.full", "torch.empty"}
_WIDTH_FLOOR = 512
#: the one sanctioned materialization: the plain route of the router
_SANCTIONED = "pdnlp_tpu_torch/ops/attention.py"


def _bcast_pattern(node: ast.AST) -> Optional[tuple]:
    """``x[:, :, None]``-style subscript -> (base name, axes) where an
    axis is "s" (a full slice) or "n" (a broadcast None); else None."""
    if not isinstance(node, ast.Subscript) \
            or not isinstance(node.value, ast.Name):
        return None
    sl = node.slice
    axes: List[str] = []
    for e in (sl.elts if isinstance(sl, ast.Tuple) else [sl]):
        if isinstance(e, ast.Slice) and e.lower is None and e.upper is None:
            axes.append("s")
        elif isinstance(e, ast.Constant) and e.value is None:
            axes.append("n")
        else:
            return None
    return (node.value.id, tuple(axes)) if "n" in axes else None


def _quadratic_width(call: ast.Call) -> Optional[int]:
    """The repeated trailing dim when the call's shape — a literal tuple or
    list argument, or the positional dims themselves (``torch.zeros(4, 1,
    512, 512)``, ``x.expand(b, 1, 512, 512)``) — ends in two equal integer
    dims >= 512."""
    shapes = [a.elts for a in list(call.args)
              + [k.value for k in call.keywords if k.arg == "size"]
              if isinstance(a, (ast.Tuple, ast.List))]
    if call.args and not isinstance(call.args[0], (ast.Tuple, ast.List)):
        shapes.append(call.args)
    for dims in shapes:
        tail = dims[-2:]
        if len(tail) == 2 and all(
                isinstance(d, ast.Constant) and type(d.value) is int
                for d in tail) and tail[0].value == tail[1].value \
                >= _WIDTH_FLOOR:
            return tail[0].value
    return None


@register
class QuadraticBiasAtWidth(Rule):
    rule_id = "R14"
    name = "quadratic-bias-at-width"
    hint = ("pass the [B, S] segment_ids (or the key bias) through to "
            "ops.attention.dot_product_attention instead: the flash "
            "kernels mask on chip from the IDs, and the plain route "
            "builds the bias at its one sanctioned site inside "
            "ops/attention.py — a hot-path [B, 1, S, S] bias is quadratic "
            "memory traffic the kernels exist to avoid")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return
        exempt = mod.path.endswith(_SANCTIONED)
        seen: set = set()
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _HOT_NAME_RE.fullmatch(fn.name):
                yield from self._check_body(mod, fn, seen, exempt)

    def _check_body(self, mod: ModuleInfo, fn: ast.AST, seen: set,
                    exempt: bool) -> Iterator[Finding]:
        for node in ast.walk(fn):
            key = (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))
            if key in seen:
                continue
            if isinstance(node, ast.Call):
                if not exempt and mod.resolves_to(node.func, _SEGMENT_BIAS):
                    seen.add(key)
                    yield self.finding(
                        mod, node,
                        "segment_bias built in a hot path — the [B, 1, S, "
                        "S] mask belongs on chip (route segment_ids to the "
                        "kernel), not in memory")
                    continue
                alloc = mod.resolves_to(node.func, _ALLOC) or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "expand")
                width = _quadratic_width(node) if alloc else None
                if width is not None:
                    seen.add(key)
                    yield self.finding(
                        mod, node,
                        f"[.., {width}, {width}] attention-bias buffer "
                        f"built in a hot path — quadratic at width {width} "
                        f"(>= {_WIDTH_FLOOR}); mask from the segment_ids / "
                        "attention_mask channels instead")
            elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                    and isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                left = _bcast_pattern(node.left)
                right = _bcast_pattern(node.comparators[0])
                if left and right and left[0] == right[0] \
                        and left[1] != right[1]:
                    seen.add(key)
                    yield self.finding(
                        mod, node,
                        f"ID outer-product compare ({left[0]}[...] == "
                        f"{right[0]}[...]) in a hot path builds the [B, S, "
                        "S] mask — route the IDs to ops.attention instead")
