"""R15 — fleet traffic-fraction and model-routing writes outside the
decision-recording path.

R13's contract, extended from knob actuations to rollout state: every
traffic shift — the canary fraction, the shadow sampling fraction, a
rollback — passes through ``ServeController._actuate``, which clamps,
records the decision chain (:mod:`pdnlp_tpu_torch.obs.decision`) and
opens the evaluation window that rolls a harmful shift back.  A write that
bypasses it moves caller traffic onto another model with no record, no
clamp and no window: the answers change, not only their latency.

Heuristic, in modules that import ``pdnlp_tpu_torch.serve.fleet`` (the
controller's rollout law, the CLI's wiring): flag

- assignments (plain or augmented) to an attribute named like a traffic
  fraction (``fleet.canary_fraction = 0.5``, ``x.shadow_fraction += 0.1``),
  and
- calls of the fleet's raw rollback and re-home surface
  (``._rollback_drain(...)``, ``.extract_queued(...)``, ``.adopt(...)``)

outside a function named ``_actuate`` or ``_apply`` (the controller's
applier) or ``apply_knob`` (the fleet's own setter, which ``_apply``
calls; ``serve/fleet.py`` and ``serve/router.py`` spell it).
``serve/fleet.py`` itself owns these attributes and does not import
itself, so it is out of scope by construction, as R13's router is.  The
rule reads no framework: it is JAX's, on the port's module names.
"""
from __future__ import annotations

import ast
from typing import Iterator

from pdnlp_tpu_torch.analysis.core import Finding, ModuleInfo, Rule, register
from pdnlp_tpu_torch.analysis.rules.r13_unrecorded_actuation import (
    sanctioned,
)

#: the traffic-split state the control plane owns once a fleet is in play
_TRAFFIC_ATTRS = {"canary_fraction", "shadow_fraction"}

#: the fleet's raw traffic-shift surface — sanctioned only beneath the
#: decision-recording path (apply_knob is the fleet's own setter)
_SHIFT_CALLS = {"_rollback_drain", "extract_queued", "adopt"}

#: functions that ARE the decision-record path (or the fleet's setter)
_SANCTIONED = {"_actuate", "_apply", "apply_knob"}

_FLEET = "pdnlp_tpu_torch.serve.fleet"


@register
class UnrecordedTrafficShift(Rule):
    rule_id = "R15"
    name = "unrecorded-traffic-shift"
    hint = ("route the traffic shift through the controller's decision-"
            "recording choke point — `self._actuate('canary_fraction', "
            "value, cause)` (or `ServeController.inject` from test or "
            "chaos code), which calls the fleet's `apply_knob` — so it is "
            "clamped, recorded as a decision chain "
            "(pdnlp_tpu_torch.obs.decision) and rolled back if parity or "
            "p99 regresses; raw fraction writes and rollback/adopt calls "
            "move caller traffic onto another model with no record")

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        if not any(v.startswith(_FLEET) or v.endswith(".FleetRouter")
                   for v in mod.aliases.values()):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and t.attr in _TRAFFIC_ATTRS \
                            and not sanctioned(mod, node, _SANCTIONED):
                        yield self.finding(
                            mod, node,
                            f"traffic fraction '{t.attr}' written outside "
                            "the _actuate decision-record path — an "
                            "unrecorded, unclamped, unevaluated traffic "
                            "shift")
                        break
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SHIFT_CALLS \
                    and not sanctioned(mod, node, _SANCTIONED):
                yield self.finding(
                    mod, node,
                    f"raw traffic-shift call '{node.func.attr}()' outside "
                    "the _actuate decision-record path — caller traffic "
                    "moves between models with no decision record and no "
                    "evaluation window")
