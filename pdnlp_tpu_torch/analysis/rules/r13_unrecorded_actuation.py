"""R13 — control-plane knob writes outside the decision-recording path.

Every actuation of a serving knob — ``hedge_ms``, ``max_wait_ms``, the
admission thresholds, the replica count — passes through
:meth:`pdnlp_tpu_torch.serve.controller.ServeController._actuate`: the one
choke point that clamps the value, holds the cooldown, hysteresis and
backoff, and records the decision chain (:mod:`pdnlp_tpu_torch.obs.
decision`) that ``python -m pdnlp_tpu_torch.tools.trace decisions``
explains.  A knob write that bypasses it changes the system with no
decision record, no clamp and no evaluation window to revert it.

Heuristic, in modules that import ``pdnlp_tpu_torch.serve.controller`` (or
are it): flag

- assignments (plain or augmented) to an attribute named like a tuning
  knob (``x.hedge_ms = ...``, ``adm.backpressure_at *= 2``), and
- calls of the router's raw setters (``.apply_knob(...)``,
  ``.deactivate_replica(...)``, ``.activate_replica(...)``)

outside a function named ``_actuate`` or ``_apply`` (the controller's
applier, which only ``_actuate`` calls).  The router and the batcher own
these attributes (their ``__init__`` and ``apply_knob`` are the setters)
and do not import the controller, so they are out of scope.  The rule
reads no framework: it is JAX's, on the port's module names.
"""
from __future__ import annotations

import ast
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register

#: the attributes the control plane owns once a controller is in play
_TUNING_ATTRS = {"hedge_ms", "max_wait_ms", "backpressure_at", "shed_at",
                 "shed_slack_ms"}

#: the router's raw actuation surface — sanctioned only beneath _actuate
_ACTUATION_CALLS = {"apply_knob", "deactivate_replica", "activate_replica"}

#: functions that ARE the decision-record path
_SANCTIONED = {"_actuate", "_apply"}

_CONTROLLER = "pdnlp_tpu_torch.serve.controller"


def sanctioned(mod: ModuleInfo, node: ast.AST, names) -> bool:
    """Is ``node`` inside a def (at any depth) named in ``names``?"""
    fn = mod.enclosing_function(node)
    while fn is not None:
        if getattr(fn, "name", None) in names:
            return True
        fn = mod.enclosing_function(fn)
    return False


@register
class UnrecordedActuation(Rule):
    rule_id = "R13"
    name = "unrecorded-actuation"
    hint = ("route the change through the controller's decision-recording "
            "choke point — `self._actuate(knob, value, cause)` (or "
            "`ServeController.inject` from test or chaos code) — so it is "
            "clamped, cooldown/hold-guarded, recorded as a decision chain "
            "(pdnlp_tpu_torch.obs.decision) and reverted if it regresses "
            "the SLO; raw `apply_knob` calls and attribute writes bypass "
            "all four")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not self._controller_module(mod):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and t.attr in _TUNING_ATTRS \
                            and not sanctioned(mod, node, _SANCTIONED):
                        yield self.finding(
                            mod, node,
                            f"tuning attribute '{t.attr}' written outside "
                            "the _actuate decision-record path — an "
                            "unrecorded, unclamped, unevaluated actuation")
                        break
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _ACTUATION_CALLS \
                    and not sanctioned(mod, node, _SANCTIONED):
                yield self.finding(
                    mod, node,
                    f"raw actuation call '{node.func.attr}()' outside the "
                    "_actuate decision-record path — the knob changes "
                    "with no decision record and no evaluation window")

    @staticmethod
    def _controller_module(mod: ModuleInfo) -> bool:
        if "pdnlp_tpu_torch/serve/controller" in mod.path:
            return True
        return any(v.startswith(_CONTROLLER)
                   or v.endswith(".ServeController")
                   for v in mod.aliases.values())
