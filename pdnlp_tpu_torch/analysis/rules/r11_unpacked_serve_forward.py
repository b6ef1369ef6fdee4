"""R11 — packed-routed serve forwards built without the segment channels.

The packed serving path holds a contract with the kernels: a serve scope
that routes *segmented* attention (the engine's ``routed_attn(seq,
segmented=True)``, ``serve/engine.py``) must feed the forward the packed
channels — ``segment_ids`` (the flash kernel's block-diagonal mask) and
``cls_positions`` (the per-segment [CLS] gather).  A forward built from the
bare padded trio (``input_ids`` / ``attention_mask`` / ``token_type_ids``)
in such a scope serves the wrong program: the kernel sees no segment IDs,
packed rows attend to each other, and every co-packed request's logits are
wrong — a corruption no retrace counter or latency gate catches.

Heuristic, per scope, in serve modules (a module under
``pdnlp_tpu_torch/serve/`` or one that imports from it): if the scope calls
a ``routed_*``-shaped function with the constant keyword
``segmented=True``, every dict built in the scope whose statically known
keys hold ``input_ids`` must hold both packed channels.  Keys are read
from dict literals and from dict comprehensions over an inline constant
tuple or list; a dict whose keys cannot be resolved statically (the
engine's ``PACKED_CHANNELS`` comprehension) is out of scope — the rule
flags provable omissions, not unknowns.  The rule reads no framework: it
is JAX's, on the port's serving package.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register

_PACKED_CHANNELS = {"segment_ids", "cls_positions"}


def _static_keys(node: ast.AST) -> Optional[Set[str]]:
    """The dict construction's key set when statically known, else None."""
    if isinstance(node, ast.Dict):
        keys: Set[str] = set()
        for k in node.keys:
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None  # **spread or computed key: unknowable
            keys.add(k.value)
        return keys
    if isinstance(node, ast.DictComp) and len(node.generators) == 1:
        it = node.generators[0].iter
        if isinstance(it, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in it.elts):
            return {e.value for e in it.elts}
    return None


def _segmented_route(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) \
        else fn.id if isinstance(fn, ast.Name) else ""
    if not name.lower().startswith("routed_"):
        return False
    return any(kw.arg == "segmented" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


@register
class UnpackedServeForward(Rule):
    rule_id = "R11"
    name = "unpacked-serve-forward"
    hint = ("a scope that routes segmented attention (segmented=True) "
            "must feed the forward the packed channels — build the batch "
            "with segment_ids + cls_positions (data.packing.pack_id_lists "
            "/ InferenceEngine.PACKED_CHANNELS), or route unsegmented for "
            "the padded path; a segment-routed forward without segment "
            "IDs serves packed rows that attend to each other")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not mod.in_serve_scope():
            return
        for _, scope, _ in mod.scopes():
            own = mod.own_nodes(scope)
            if not any(_segmented_route(n) for n in own):
                continue
            for node in own:
                keys = _static_keys(node)
                if keys is None or "input_ids" not in keys:
                    continue
                missing = sorted(_PACKED_CHANNELS - keys)
                if missing:
                    yield self.finding(
                        mod, node,
                        "forward batch built without the packed channels "
                        f"({'/'.join(missing)}) in a scope that routes "
                        "segmented attention — the kernel would serve "
                        "packed rows with no block-diagonal mask")
