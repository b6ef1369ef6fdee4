"""R6 — mesh axis names no mesh declares.

The port names its mesh axes as JAX does (``parallel/mesh.py``
``KNOWN_AXES``: ``data``, ``model``, ``expert``, ``seq``, ``stage``).  A
typo'd axis in a mesh shape is refused at startup, but one in a group
lookup is not always: ``axis_group(mesh, "modle")`` on a mesh without the
axis returns this rank alone (a group of one), so a collective over it
reduces nothing and a sharded run silently trains each rank on its own
gradients.  This rule parses the vocabulary from ``mesh.py`` — by AST,
never importing — and flags every string axis that is not in it:

- the axis of ``axis_group(mesh, "...")`` / ``axis_size(mesh, "...")``
  and of a ``DeviceMesh``'s ``get_group("...")`` / ``get_local_rank``,
  and ``mesh["..."]``;
- the keys of a mesh-shape dict: ``mesh_shape=`` / ``shape=`` keyword
  values, ``make_mesh`` / ``mesh_dims`` arguments, assignments to a
  ``*mesh*`` name, and dicts returned by a ``*mesh*`` function;
- ``mesh_dim_names=`` of ``init_device_mesh``.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator, Optional, Set

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, dotted_name, register,
)

#: fallback when mesh.py cannot be parsed (e.g. analyzer vendored elsewhere)
_DEFAULT_AXES = {"data", "model", "expert", "seq", "stage"}

_MESH_PY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "parallel", "mesh.py")


def declared_axes(mesh_path: str = _MESH_PY) -> Set[str]:
    """Axis names declared in mesh.py: every module-level UPPER_CASE
    assignment of a string constant (``DATA_AXIS = "data"``), tuple
    unpacking of string constants, and the ``KNOWN_AXES`` registry tuple."""
    try:
        with open(mesh_path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return set(_DEFAULT_AXES)
    axes: Set[str] = set()
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            names = [target] if isinstance(target, ast.Name) else (
                list(target.elts) if isinstance(target, (ast.Tuple, ast.List))
                else [])
            if not all(isinstance(n, ast.Name) and n.id.isupper()
                       for n in names) or not names:
                continue
            for v in ast.walk(node.value):
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    axes.add(v.value)
    return axes or set(_DEFAULT_AXES)


@register
class UnknownMeshAxis(Rule):
    rule_id = "R6"
    name = "unknown-mesh-axis"
    hint = ("use an axis declared in pdnlp_tpu_torch/parallel/mesh.py "
            "KNOWN_AXES (or add the new axis there so every subsystem "
            "agrees on it)")

    def __init__(self):
        self._axes: Optional[Set[str]] = None

    @property
    def axes(self) -> Set[str]:
        if self._axes is None:
            self._axes = declared_axes()
        return self._axes

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(mod, node)
            elif isinstance(node, ast.Subscript) and "mesh" in (
                    dotted_name(node.value) or "").lower():
                yield from self._names(mod, [node.slice])
            elif isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Dict) and any(
                    "mesh" in (dotted_name(t) or "").lower()
                    for t in node.targets):
                yield from self._names(mod, node.value.keys)
            elif isinstance(node, ast.Return) and isinstance(
                    node.value, ast.Dict):
                fn = mod.enclosing_function(node)
                if "mesh" in getattr(fn, "name", ""):
                    yield from self._names(mod, node.value.keys)

    def _check_call(self, mod: ModuleInfo, call: ast.Call
                    ) -> Iterator[Finding]:
        name = (dotted_name(call.func) or "").split(".")[-1]
        kw = {k.arg: k.value for k in call.keywords if k.arg}
        if name in ("axis_group", "axis_size"):
            yield from self._names(mod, call.args[1:2] + [kw.get("axis")])
        elif name in ("get_group", "get_local_rank", "size") and isinstance(
                call.func, ast.Attribute) and "mesh" in (
                dotted_name(call.func.value) or "").lower():
            yield from self._names(mod, call.args[:1]
                                   + [kw.get("mesh_dim")])
        elif name in ("make_mesh", "mesh_dims"):
            yield from self._dict_keys(mod, list(call.args) + list(
                kw.values()))
        if name == "init_device_mesh" and "mesh_dim_names" in kw:
            v = kw["mesh_dim_names"]
            yield from self._names(mod, getattr(v, "elts", [v]))
        for key in ("mesh_shape", "shape"):
            if key in kw and name not in ("make_mesh", "mesh_dims"):
                yield from self._dict_keys(mod, [kw[key]])

    def _dict_keys(self, mod: ModuleInfo, values) -> Iterator[Finding]:
        for v in values:
            if isinstance(v, ast.Dict):
                yield from self._names(mod, v.keys)

    def _names(self, mod: ModuleInfo, nodes) -> Iterator[Finding]:
        for v in nodes:
            if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                    and v.value not in self.axes:
                yield self.finding(
                    mod, v,
                    f"mesh axis '{v.value}' is not declared by any mesh "
                    "(pdnlp_tpu_torch/parallel/mesh.py KNOWN_AXES) — a "
                    "group over it is this rank alone, and a collective "
                    "over it reduces nothing")
