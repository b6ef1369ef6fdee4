"""T1 — lock-guarded attribute touched outside the lock.

For each class that owns a ``threading.Lock``/``RLock`` (Conditions alias
the lock they wrap), infer the guarded attribute set: attributes whose
accesses occur at least :data:`MIN_GUARDED` times while the lock is held
— counting helper methods that inherit the lock interprocedurally
(``_finish_locked`` is guarded because every call site holds the lock) —
and that are WRITTEN somewhere outside ``__init__`` (a reference assigned
once at construction cannot race, however often it is read).

Then flag every read/write of a guarded attribute on a thread-reachable
path that does not hold the lock.  Thread reachability is seeded from
``threading.Thread(target=...)`` / ``threading.Timer`` spawns and
``Thread`` subclass ``run`` methods — the serving stack's worker/monitor/
harvester entry points — and closed over the program call graph, so an
unlocked touch buried two helpers deep under a worker loop still lands an
exact ``file:line``.

Two finding shapes:

- a direct access in a thread-reachable non-helper method;
- a CALL to a same-class helper from a site that does not hold the lock,
  when the helper's body (transitively) touches guarded attributes that
  its own ``with`` blocks do not cover — the finding cites the call site
  (that is where the lock is missing), naming the helper and attribute.

``__init__`` is exempt (construction is single-threaded by convention),
and so are methods that are not thread-reachable: a lifecycle method only
the owning thread calls cannot race the worker it has not started yet.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterator, Set, Tuple

from pdnlp_tpu_torch.analysis.core import Finding, ProgramInfo, ProgramRule, register
from pdnlp_tpu_torch.analysis.concurrency.model import (
    ConcurrencyModel, LockToken, get_model, method_key, token_display,
)

#: guarded-set inference threshold: accesses under the lock before an
#: attribute counts as lock-guarded
MIN_GUARDED = 2


@register
class UnguardedSharedAttr(ProgramRule):
    rule_id = "T1"
    name = "unguarded-shared-attr"
    suite = "concurrency"
    hint = ("take the owning lock around the access (`with self._lock:`) "
            "— or, when the invariant is upheld by construction (e.g. the "
            "write happens-before Thread.start()), suppress with "
            "`# torchlint: disable=T1` and a written reason")

    def check_program(self, prog: ProgramInfo) -> Iterator[Finding]:
        model = get_model(prog)
        for cls_qual in sorted(model.class_locks):
            yield from self._check_class(model, cls_qual)

    # ------------------------------------------------------------ per-class
    def _check_class(self, model: ConcurrencyModel,
                     cls_qual: str) -> Iterator[Finding]:
        if not model.class_is_threaded(cls_qual):
            return
        cm = model.prog.classes[cls_qual]
        entry = model.entry_held(cls_qual)
        lock_attrs = model.lock_attrs(cls_qual)
        own_tokens = model.class_tokens(cls_qual)

        counts: Dict[Tuple[LockToken, str], int] = {}
        written: Set[str] = set()
        for mname, facts in model.methods_of(cls_qual):
            if mname == "__init__":
                continue
            ent = entry.get(mname, frozenset())
            for a in facts.accesses:
                if a.attr in lock_attrs or a.attr in cm.methods:
                    continue
                if a.write:
                    written.add(a.attr)
                for tok in (a.held | ent) & own_tokens:
                    counts[(tok, a.attr)] = counts.get((tok, a.attr), 0) + 1
        guarded: Dict[LockToken, Set[str]] = {}
        for (tok, attr), n in counts.items():
            if n >= MIN_GUARDED and attr in written:
                guarded.setdefault(tok, set()).add(attr)
        if not guarded:
            return

        callsites = model.intraclass_callsite_counts(cls_qual)

        def is_helper(mname: str) -> bool:
            return (mname.startswith("_") and not mname.startswith("__")
                    and callsites.get(mname, 0) > 0
                    and method_key(cls_qual, mname)
                    not in model.thread_entries)

        exposed_memo: Dict[str, Set[Tuple[str, FrozenSet[LockToken]]]] = {}
        for mname, facts in sorted(model.methods_of(cls_qual)):
            if mname == "__init__" or \
                    method_key(cls_qual, mname) not in model.thread_reachable:
                continue
            ent = entry.get(mname, frozenset())
            if not is_helper(mname):  # helpers are judged at call sites
                for a in facts.accesses:
                    eff = a.held | ent
                    for tok in sorted(guarded):
                        if a.attr in guarded[tok] and tok not in eff:
                            yield self.finding(
                                facts.mod, a.node,
                                f"{'write to' if a.write else 'read of'} "
                                f"'{a.attr}' outside {token_display(tok)} "
                                f"— the attribute is lock-guarded "
                                f"({counts[(tok, a.attr)]} guarded "
                                f"accesses) and `{mname}` runs on a "
                                f"thread-reachable path")
                            break
            for c in facts.calls:
                prefix = f"m:{cls_qual}."
                if c.callee is None or not c.callee.startswith(prefix):
                    continue
                callee_name = c.callee[len(prefix):]
                if not is_helper(callee_name):
                    continue
                eff = c.held_tokens() | ent
                flagged: Set[str] = set()
                for attr, hs in sorted(
                        self._exposed(model, cls_qual, callee_name,
                                      exposed_memo),
                        key=lambda p: p[0]):
                    for tok in sorted(guarded):
                        if attr in guarded[tok] and tok not in hs \
                                and tok not in eff and attr not in flagged:
                            flagged.add(attr)
                            yield self.finding(
                                facts.mod, c.node,
                                f"call to {cm.name}.{callee_name}() "
                                f"without holding {token_display(tok)} — "
                                f"the helper touches lock-guarded "
                                f"'{attr}' and `{mname}` runs on a "
                                f"thread-reachable path")

    # ------------------------------------------------------------- exposure
    def _exposed(self, model: ConcurrencyModel, cls_qual: str, mname: str,
                 memo: Dict[str, Set[Tuple[str, FrozenSet[LockToken]]]],
                 ) -> Set[Tuple[str, FrozenSet[LockToken]]]:
        """(attr, locks-held-locally) pairs a helper's body touches,
        transitively through same-class calls (each nested call adds the
        locks held AT that call) — what a call site must cover itself."""
        if mname in memo:
            return memo[mname]
        memo[mname] = set()  # cycle guard
        facts = model.facts.get(method_key(cls_qual, mname))
        if facts is None:
            return memo[mname]
        cm = model.prog.classes[cls_qual]
        lock_attrs = model.lock_attrs(cls_qual)
        out: Set[Tuple[str, FrozenSet[LockToken]]] = set()
        for a in facts.accesses:
            if a.attr not in lock_attrs and a.attr not in cm.methods:
                out.add((a.attr, a.held))
        prefix = f"m:{cls_qual}."
        for c in facts.calls:
            if c.callee is None or not c.callee.startswith(prefix):
                continue
            sub = self._exposed(model, cls_qual, c.callee[len(prefix):],
                                memo)
            out |= {(attr, hs | c.held_tokens()) for attr, hs in sub}
        memo[mname] = out
        return out
