"""R8 — attention pinned to the plain path inside a hot path.

``ops.attention.routed_impl`` is the one place that decides the attention
impl: ``"auto"`` is the flash kernels (K1-K3) on the card and the plain
path elsewhere, and dropout, causal or cached queries take the plain path
by rule.  Pinning ``impl="xla"`` (the port's name for the plain path, as
in JAX; ``"plain"`` / ``"sdpa"`` too) inside a train step builder, a step
or the model's layers silently forfeits the kernels for every run, and
calling ``F.scaled_dot_product_attention`` there bypasses the routing
(and the kernels' launch counts) altogether.  The escape hatch belongs at
the CLI (``--attention_impl xla``), where it is visible in the run
config.

Heuristic, scoped to *hot-path* functions — a function whose name is
step-builder- or step-shaped (``build_*step*`` / ``make_*step*``,
``*_step``, ``step_fn``) or a model forward (``forward`` / ``_forward``
/ ``encode`` / ``classify`` / ``__call__``), including functions nested
in them — outside ``ops/attention.py`` itself:

- a call carrying ``impl=`` / ``attn_impl=`` / ``attention_impl=`` as the
  STRING LITERAL ``"xla"``, ``"plain"`` or ``"sdpa"``;
- an assignment to an ``*impl*`` name from a conditional expression with
  such a literal arm (``x if cond else "xla"``);
- a call of ``torch.nn.functional.scaled_dot_product_attention``.

A/B probes pass the impl as a VARIABLE (``for impl in ("xla", "auto")``)
and are not flagged; a deliberate pin takes an inline
``# torchlint: disable=R8`` with its justification.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register

_HOT_NAME_RE = re.compile(
    r"^(build|make)_\w*step\w*$|^\w*step(_fn)?$"
    r"|^_?(forward|encode|classify)$|^__call__$")
_IMPL_KWARGS = {"impl", "attn_impl", "attention_impl"}
_IMPL_NAME_RE = re.compile(r"impl")
_LIB_ATTENTION = {"torch.nn.functional.scaled_dot_product_attention"}
_PLAIN = {"xla", "plain", "sdpa"}
#: the routing module itself: it implements the plain path
_ROUTER = "ops/attention.py"


def _is_xla_literal(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value in _PLAIN


@register
class XlaAttentionInHotPath(Rule):
    rule_id = "R8"
    name = "plain-attention-in-hot-path"
    hint = ("let ops.attention route the impl: pass args.attention_impl "
            "through (\"auto\" resolves to the flash kernels on the card, "
            "dropout / causal / cached queries in hand); force the plain "
            "path from the CLI with --attention_impl xla, not a pin inside "
            "the builder")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.path.endswith(_ROUTER):
            return
        # one module-wide position set: a hot fn nested in a hot fn (the
        # builder-returns-step idiom) is walked from both scopes — each
        # site still reports once
        seen: set = set()
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _HOT_NAME_RE.fullmatch(fn.name):
                continue
            yield from self._check_body(mod, fn, seen)

    def _check_body(self, mod: ModuleInfo, fn: ast.AST,
                    seen: set) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if mod.resolves_to(node.func, _LIB_ATTENTION):
                    key = (node.lineno, node.col_offset)
                    if key not in seen:
                        seen.add(key)
                        yield self.finding(
                            mod, node,
                            "F.scaled_dot_product_attention in a hot path "
                            "bypasses ops.attention's routing — the flash "
                            "kernels never run here")
                for kw in node.keywords:
                    if kw.arg in _IMPL_KWARGS and _is_xla_literal(kw.value):
                        key = (kw.value.lineno, kw.value.col_offset)
                        if key not in seen:
                            seen.add(key)
                            yield self.finding(
                                mod, kw.value,
                                f"attention pinned to the plain path "
                                f"({kw.arg}={kw.value.value!r}) inside a "
                                "hot path — the flash kernels never run "
                                "here")
            elif isinstance(node, ast.Assign):
                yield from self._check_demotion(mod, node, seen)

    def _check_demotion(self, mod: ModuleInfo, node: ast.Assign,
                        seen: set) -> Iterator[Finding]:
        """``attn_impl = <x> if <cond> else "xla"`` — the idiom that
        silently demotes every "auto" run to the plain path."""
        targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        if not any(_IMPL_NAME_RE.search(t) for t in targets):
            return
        if not isinstance(node.value, ast.IfExp):
            return
        for arm in (node.value.body, node.value.orelse):
            if _is_xla_literal(arm):
                key = (arm.lineno, arm.col_offset)
                if key not in seen:
                    seen.add(key)
                    yield self.finding(
                        mod, node,
                        "impl assignment demotes \"auto\" to the plain "
                        "path in a hot path — every default run forfeits "
                        "the flash kernels")
                return
