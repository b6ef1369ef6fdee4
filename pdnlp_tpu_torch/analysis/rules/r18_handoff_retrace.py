"""R18 — a handoff export or import whose shape follows the live page
count.

The split pools' KV handoff (``pdnlp_tpu_torch.serve.decode``: the
prefill pool's ``export_pages``, the decode pool's ``import_pages``) stays
free of recaptures by construction: both programs take the FULL
``[pages_per_stream]`` table row, padded past the stream's real pages
with the sentinel ``n_pages`` (the zero page on export, the sink on
import), so one graph keyed ``("export" | "import", pages_per_stream)``
serves every stream whatever its prompt's length.  The tempting spelling
inverts that::

    pages = [p for p in table[slot] if p < n_pages]
    k, v = export_fn(cache_k, cache_v, torch.tensor(pages))   # <- R18
    import_fn(cache_k, cache_v, pk, pv, dst[:len(pages)])      # <- R18

Sizing the gather or scatter index to the runtime page count gives every
prompt-length bucket its own program key — a handoff storm captures a
graph per page count instead of replaying the one warmed graph, and
time to first token pays for it.

Heuristic, per function: a HANDOFF dispatch — a call whose name's last
segment contains ``export`` or ``import`` — with an argument that is (a)
sliced by a bound naming a value (``dst[:n_live]``), or (b) a name bound
in the function to a comprehension or ``filter`` (the live-page list),
bare or wrapped in ``asarray`` / ``array`` / ``tensor`` / ``as_tensor`` /
``stack`` / ``cat`` / ``concatenate``.  Full-width rows, sentinel
``np.full`` padding, literal bounds and the runtime count passed as scalar
data (``len(pages)``) never match.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Set

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, call_last_name, has_runtime_slice, register,
)

_HANDOFF_CALL_RE = re.compile(r"(export|import)", re.I)
_WRAP_FUNCS = frozenset(("asarray", "array", "tensor", "as_tensor", "stack",
                         "cat", "concatenate"))


def _varlen_value(v: ast.AST) -> bool:
    """A value whose LENGTH only the run knows: a comprehension, a
    ``filter(...)``, or ``list(...)`` of either."""
    if isinstance(v, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        return True
    if isinstance(v, ast.Call):
        last = call_last_name(v)
        return last == "filter" or (last == "list" and bool(v.args)
                                    and _varlen_value(v.args[0]))
    return False


@register
class PerStreamHandoffRetrace(Rule):
    rule_id = "R18"
    name = "per-stream-handoff-retrace"
    hint = ("dispatch the handoff export/import at the FULL fixed "
            "[pages_per_stream] table extent, padded past the stream's "
            "live pages with the sentinel n_pages "
            "(pdnlp_tpu_torch.serve.decode export_pages/import_pages are "
            "the engine forms — program keys ('export'|'import', "
            "pages_per_stream)) — sizing the index to the runtime page "
            "count gives every prompt-length bucket its own program, so a "
            "handoff storm captures a graph per page count instead of "
            "replaying the one warmed graph")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.imports_torch():
            return
        varlen: Dict[ast.AST, Set[str]] = {}
        for call in ast.walk(mod.tree):
            if not isinstance(call, ast.Call) \
                    or not _HANDOFF_CALL_RE.search(call_last_name(call)):
                continue
            fn = mod.enclosing_function(call)
            while isinstance(fn, ast.Lambda):
                fn = mod.enclosing_function(fn)
            if fn is None:
                continue
            if fn not in varlen:
                varlen[fn] = {t.id for node in ast.walk(fn)
                              if isinstance(node, ast.Assign)
                              and _varlen_value(node.value)
                              for t in node.targets
                              if isinstance(t, ast.Name)}
            if has_runtime_slice(call) \
                    or self._passes_varlen(call, varlen[fn]):
                yield self.finding(
                    mod, call,
                    "handoff export/import dispatched with a "
                    "runtime-page-count shape — every distinct live page "
                    "count is a new program, so the handoff captures a "
                    "graph per prompt-length bucket instead of replaying "
                    "the one fixed [pages_per_stream] padded program")

    @staticmethod
    def _passes_varlen(call: ast.Call, varlen: Set[str]) -> bool:
        """An argument that IS a live-page list or a tensor built from
        one; a varlen name buried in other calls (``len(pages)``) is
        scalar data, the sanctioned spelling."""
        def varlen_expr(e: ast.AST) -> bool:
            if isinstance(e, ast.Name):
                return e.id in varlen
            if isinstance(e, (ast.ListComp, ast.GeneratorExp)):
                return True
            if isinstance(e, ast.Call) and call_last_name(e) in _WRAP_FUNCS:
                return any(varlen_expr(a) for a in e.args)
            return False

        return any(varlen_expr(a) for a in
                   list(call.args) + [kw.value for kw in call.keywords])
