"""R16 — a KV cache rebuilt by concatenation inside a decode loop.

The decode path holds two properties by construction
(``pdnlp_tpu_torch.serve.decode``): the KV cache is PREALLOCATED (the
slot cache ``[L, slots, max_len, N, D]``, the paged pool ``[L, n_pages +
2, page_sz, N, D]``; decoding allocates nothing) and the decode step has
ONE fixed shape, so one captured CUDA graph replays every token.  The
textbook anti-pattern breaks both::

    for _ in range(max_new):
        logits, k_new, v_new = decode_step(model, tok, k_cache, v_cache)
        k_cache = torch.cat([k_cache, k_new], dim=2)        # <- R16

Every token reallocates the whole cache (O(T^2) bytes over a generation)
and hands the step a new shape, so the graph is captured again per token.
The paged layout has its own spelling of the bug: the per-stream page
table or the page pool rebuilt by ``torch.cat`` / ``torch.stack`` as
pages are claimed, or the pages collected in a list and stacked.

Heuristic, per lexical ``for`` / ``while`` loop (R7 and R9's loop-body
machinery): the loop is DECODE-SHAPED — it calls something whose name's
last segment contains ``decode`` / ``prefill`` / ``generate`` or is
step-shaped — and its body

- calls ``torch.cat`` / ``concat`` / ``concatenate`` / ``stack`` /
  ``hstack`` / ``vstack`` or ``np.concatenate`` / ``stack`` / ``append``
  with an argument naming KV state (``kv`` / ``cache`` / ``past`` /
  ``page`` in the identifier, inside list and tuple literals too), or
- appends to a list named so (``past.append(kv)``) that the function
  then stacks or concatenates.

The fix — ``index_copy_``, slice assignment into the preallocated cache,
the table row written in place — never matches; nor does concatenating
the output tokens, nor a one-time assembly outside any decode loop
(``models/decoder.py``'s prefill stacks its per-layer K/V once).
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, Set

from pdnlp_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, call_last_name, is_step_call, loop_body_calls,
    register,
)

_REBUILD = {f"torch.{n}" for n in ("cat", "concat", "concatenate", "stack",
                                   "hstack", "vstack")} \
    | {f"numpy.{n}" for n in ("concatenate", "stack", "hstack", "vstack",
                              "append")}
_DECODE_CALL_RE = re.compile(r"(decode|prefill|generate)", re.I)
_CACHE_NAME_RE = re.compile(r"(kv|cache|past|page)", re.I)


def _cache_ident(node: ast.AST) -> str:
    ident = node.id if isinstance(node, ast.Name) else node.attr \
        if isinstance(node, ast.Attribute) else ""
    return ident if _CACHE_NAME_RE.search(ident) else ""


@register
class KVCacheReallocInDecodeLoop(Rule):
    rule_id = "R16"
    name = "kv-cache-realloc-in-decode-loop"
    hint = ("allocate the KV storage once (the [slots, max_len] slot "
            "cache, or the paged pool with a fixed [slots, "
            "pages_per_stream] page table) and write each token's K/V in "
            "place — cache.index_copy_(dim, pos, k_new), a slice "
            "assignment cache[:, rows, pos] = k_new, the table row "
            "written in place at attach (pdnlp_tpu_torch.serve.decode "
            "DecodeEngine / PagedDecodeEngine are the engine forms) — a "
            "cat/stack rebuild reallocates the whole cache or table every "
            "token and its growing shape captures a new graph per token")

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
            stacked = self._stacked_lists(mod, loop)
            for c in calls:
                if mod.resolves_to(c.func, _REBUILD) and self._names_cache(c):
                    yield self.finding(
                        mod, c,
                        "KV cache rebuilt by concatenation inside a decode "
                        "loop — every token reallocates the whole cache and "
                        "its growing shape is a new program per token")
                elif isinstance(c.func, ast.Attribute) \
                        and c.func.attr == "append" \
                        and _cache_ident(c.func.value) in stacked:
                    yield self.finding(
                        mod, c,
                        "KV state appended to a list the decode loop's "
                        "function stacks — the cache is rebuilt from the "
                        "list instead of written in place")

    def _stacked_lists(self, mod: ModuleInfo, loop: ast.AST) -> Set[str]:
        """Cache-named identifiers passed to a rebuild call anywhere in the
        loop's function (or module)."""
        scope = mod.enclosing_function(loop) or mod.tree
        out: Set[str] = set()
        for n in ast.walk(scope):
            if isinstance(n, ast.Call) and mod.resolves_to(n.func, _REBUILD):
                for arg in list(n.args) + [k.value for k in n.keywords]:
                    for a in ast.walk(arg):
                        ident = _cache_ident(a)
                        if ident:
                            out.add(ident)
        return out

    @staticmethod
    def _names_cache(call: ast.Call) -> bool:
        return any(_cache_ident(n) for arg in list(call.args)
                   + [k.value for k in call.keywords]
                   for n in ast.walk(arg))
