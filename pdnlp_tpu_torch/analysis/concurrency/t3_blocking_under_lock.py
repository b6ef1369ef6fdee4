"""T3 — blocking call while holding a lock.

A pool-level lock is the serving tier's convoy point: every submitter,
worker and monitor wake funnels through it.  Anything that can park the
holder — an unbounded ``queue.put``/``get``, ``Future.result()``, a
``Thread.join()``, a device sync (``torch.cuda.synchronize``, an event's or
a stream's ``synchronize()``, ``.item()`` / ``.cpu()`` / ``.tolist()``) or
a step dispatch, file or
socket I/O, a bare ``sleep`` — extends the critical section by the full
wait and serializes the pool against it (the PR-9 "packing under the one
lock serialized every worker" bug class).

Checked both directly (a blocking call lexically inside ``with self._lock``)
and interprocedurally: a call made under the lock to a function/method
whose body (transitively, through resolvable call edges) performs blocking
work — the finding lands on the call site, citing the blocking operation's
own ``file:line``, because the call site is where the lock scope is wrong.

Sanctioned shapes that do NOT flag:

- ``cond.wait(...)`` on a Condition wrapping a lock you hold — that is
  the one blocking call DESIGNED to run under its lock (it releases it);
- any wait/join/get/put given a ``timeout`` (bounded stall, a latency
  bug at worst — not a wedge);
- ``put_nowait``/``get_nowait``;
- blocking work after the ``with`` block closed (the snapshot-then-work
  pattern the repo's batch formation uses).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from pdnlp_tpu_torch.analysis.core import (
    Finding, ProgramInfo, ProgramRule, dotted_name, is_step_call, register,
)
from pdnlp_tpu_torch.analysis.concurrency.model import (
    CallFact, ConcurrencyModel, FuncKey, FunctionFacts, get_model,
    token_display,
)

_SLEEPERS = {"time.sleep"}
_SUBPROCESS = {"subprocess.run", "subprocess.call", "subprocess.check_call",
               "subprocess.check_output"}
_FILE_IO = {"os.replace", "os.rename", "os.fsync", "os.makedirs",
            "shutil.copyfile", "shutil.copy", "shutil.move",
            "json.dump", "pickle.dump", "numpy.save"}
_DEVICE_SYNC = {"torch.cuda.synchronize"}
#: methods that wait for the card: an event's or a stream's synchronize,
#: and the reads that copy a tensor to the host
_DEVICE_SYNC_METHODS = {"synchronize", "item", "cpu", "tolist"}
_QUEUE_TYPES = {"queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
                "queue.SimpleQueue"}
_SOCKET_BLOCKING_METHODS = {"recv", "send", "sendall", "accept", "connect"}
#: step-dispatch naming: the port's step convention plus jit-prefixed
#: callables and the engine forward surface
_JIT_NAME_RE = re.compile(r"(^|_)jit(_|$)")
_ENGINE_DISPATCH = {"infer_ids", "infer_packed", "prefill_ids",
                    "decode_batch", "warmup_packed"}

_MAX_DEPTH = 3


def _has_timeout(call: ast.Call) -> bool:
    return any(kw.arg == "timeout" and not (
        isinstance(kw.value, ast.Constant) and kw.value.value is None)
        for kw in call.keywords)


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def classify_blocking(facts: FunctionFacts, c: CallFact,
                      resolved_in_program: bool = False
                      ) -> Optional[Tuple[str, str]]:
    """``(kind, detail)`` when this call can block unboundedly, else None.
    Receiver-sensitive checks use the type model (``self._q`` known to be
    a ``queue.Queue``); the Condition-wait exemption uses the held-set at
    the call.  The step-dispatch NAME heuristics only apply when the
    callee does NOT resolve to a scanned function — a resolvable callee
    is judged by what its body actually does (the interprocedural
    summary), not by what it is called (``_close_step`` is an obs
    helper, not a step)."""
    call = c.node
    mod = facts.mod
    resolved = mod.resolve(call.func)
    if resolved in _SLEEPERS:
        return ("sleep", "time.sleep holds the lock for the full nap")
    if resolved in _SUBPROCESS:
        return ("subprocess", f"{resolved} blocks on the child process")
    if resolved == "open" or resolved in _FILE_IO:
        return ("file I/O", f"{resolved} touches the filesystem")
    if resolved in _DEVICE_SYNC:
        return ("device sync", f"{resolved} waits for the device stream")
    if is_step_call(call) and not resolved_in_program:
        name = dotted_name(call.func) or "<step>"
        # the repo's callback convention (`on_step`, `on_death`) shares
        # the *step suffix but names a handler, not a dispatch
        if not name.split(".")[-1].startswith("on_"):
            return ("step dispatch",
                    f"{name} dispatches compiled device work")
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        recv = c.recv_type
        if not resolved_in_program and (
                _JIT_NAME_RE.search(attr) or attr in _ENGINE_DISPATCH):
            return ("step dispatch",
                    f".{attr}() dispatches compiled device work")
        if attr in _DEVICE_SYNC_METHODS and not call.args:
            return ("device sync",
                    f".{attr}() waits for the device stream")
        if attr == "result" and not call.args and not _has_timeout(call):
            return ("future wait", ".result() with no timeout")
        if attr == "join" and not call.args and not _has_timeout(call):
            if recv == "threading.Thread" or _thread_named(call.func.value):
                return ("thread join", ".join() with no timeout")
        if attr in ("put", "get") and recv in _QUEUE_TYPES:
            block_arg = call.args[1] if attr == "put" and len(call.args) > 1 \
                else (call.args[0] if attr == "get" and call.args else None)
            blocking_false = (isinstance(block_arg, ast.Constant)
                              and block_arg.value is False) or (
                isinstance(_kw(call, "block"), ast.Constant)
                and _kw(call, "block").value is False)
            if not blocking_false and not _has_timeout(call):
                return ("queue wait", f".{attr}() with no timeout")
        if attr == "wait":
            if recv == "threading.Event" and not call.args \
                    and not _has_timeout(call):
                return ("event wait", "Event.wait() with no timeout")
            # Condition.wait on a lock you HOLD is the sanctioned shape
            # (it releases the lock); on one you don't, an unbounded
            # wait extends whatever you DO hold
            if c.recv_token is not None \
                    and c.recv_token not in c.held_tokens() \
                    and not call.args and not _has_timeout(call):
                return ("condition wait",
                        f"waiting {token_display(c.recv_token)} "
                        "with no timeout")
        if attr in _SOCKET_BLOCKING_METHODS and recv == "socket.socket":
            return ("socket I/O", f".{attr}() blocks on the peer")
    return None


def _thread_named(recv: ast.AST) -> bool:
    dn = dotted_name(recv) or ""
    last = dn.split(".")[-1].lower()
    return any(s in last for s in ("thread", "worker", "harvester",
                                   "monitor"))


@register
class BlockingCallUnderLock(ProgramRule):
    rule_id = "T3"
    name = "blocking-call-under-lock"
    suite = "concurrency"
    hint = ("move the blocking work outside the `with` block — snapshot "
            "what you need under the lock, release, then block (the "
            "_PackIntent pattern); for waits, pass a timeout so a wedge "
            "is a latency blip, not a deadlock")

    def check_program(self, prog: ProgramInfo) -> Iterator[Finding]:
        model = get_model(prog)
        summaries: Dict[FuncKey, List[Tuple[str, str, str]]] = {}
        for key in sorted(model.facts):
            facts = model.facts[key]
            for c in facts.calls:
                if not c.held:
                    continue
                verdict = classify_blocking(
                    facts, c, c.callee is not None and c.callee in model.facts)
                lock_tok, lock_site = c.held[0]
                where = (f"{token_display(lock_tok)} (acquired "
                         f"{facts.mod.path}:"
                         f"{getattr(lock_site, 'lineno', '?')})")
                if verdict is not None:
                    kind, detail = verdict
                    yield self.finding(
                        facts.mod, c.node,
                        f"{kind} while holding {where} — {detail}")
                    continue
                if c.callee is None or c.callee not in model.facts:
                    continue
                inner = self._blocking_summary(model, c.callee, summaries,
                                               _MAX_DEPTH)
                if inner:
                    kind, detail, site = inner[0]
                    callee_name = c.callee.split(".")[-1]
                    yield self.finding(
                        facts.mod, c.node,
                        f"call to {callee_name}() performs {kind} "
                        f"({site}: {detail}) while holding {where}")

    def _blocking_summary(self, model: ConcurrencyModel, key: FuncKey,
                          memo: Dict, depth: int
                          ) -> List[Tuple[str, str, str]]:
        """(kind, detail, file:line) blocking operations reachable inside
        ``key`` — what calling it under a lock drags into the critical
        section."""
        if key in memo:
            return memo[key]
        memo[key] = []  # cycle guard
        if depth <= 0:
            return memo[key]
        facts = model.facts.get(key)
        if facts is None:
            return memo[key]
        out: List[Tuple[str, str, str]] = []
        for c in facts.calls:
            verdict = classify_blocking(
                facts, c, c.callee is not None and c.callee in model.facts)
            if verdict is not None:
                kind, detail = verdict
                out.append((kind, detail,
                            f"{facts.mod.path}:"
                            f"{getattr(c.node, 'lineno', '?')}"))
            elif c.callee is not None and c.callee in model.facts:
                out.extend(self._blocking_summary(model, c.callee, memo,
                                                  depth - 1))
        memo[key] = out
        return out
