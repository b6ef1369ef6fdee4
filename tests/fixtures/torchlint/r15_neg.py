"""R15 negatives: the sanctioned ``_actuate``/``_apply``/``apply_knob``
path, computing a target without actuating it, and non-traffic writes."""
from pdnlp_tpu_torch.serve.fleet import FleetRouter, RolloutPlan  # noqa: F401


class TinyController:
    def _actuate(self, fleet, knob, value, cause):
        # THE choke point: clamp + decision record + eval window
        fleet.apply_knob(knob, value)
        fleet.canary_fraction = value  # a write inside _actuate is fine

    def _apply(self, fleet, value):
        # _actuate's private applier: part of the sanctioned path
        if value == 0.0:
            fleet._rollback_drain()

    def decide(self, fleet, mismatch_rate):
        # computing the next step is not shifting traffic
        target = 0.0 if mismatch_rate > 0.02 else 0.25
        self._actuate(fleet, "canary_fraction", target,
                      {"mismatch_rate": mismatch_rate})


class TinyFleet:
    def apply_knob(self, name, value):
        # the fleet's own setter surface IS sanctioned (R13's router
        # precedent): _apply calls it, and it owns the attribute
        self.canary_fraction = float(value)


def read_only(fleet):
    return fleet.knob_values()["canary_fraction"]


def unrelated_attrs(fleet):
    fleet.harvest_interval_s = 0.5  # not traffic state
    fleet.note = "canary_fraction"
