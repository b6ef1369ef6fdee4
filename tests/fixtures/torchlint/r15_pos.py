"""R15 positives: traffic-fraction writes and raw traffic-shift calls
that bypass the controller's decision-recording ``_actuate`` path."""
from pdnlp_tpu_torch.serve.fleet import FleetRouter  # noqa: F401


def hand_rollout(fleet):
    fleet.canary_fraction = 0.5


def creep_shadow(fleet):
    fleet.shadow_fraction += 0.1


def panic_rollback(fleet):
    fleet._rollback_drain()


def hand_drain(candidate_group, primary_group):
    for r in candidate_group.extract_queued():
        primary_group.adopt(r)
