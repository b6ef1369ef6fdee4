"""R13 positives: knob writes and raw actuation calls that bypass the
controller's decision-recording ``_actuate`` path."""
from pdnlp_tpu_torch.serve.controller import ServeController  # noqa: F401


def hand_tune(router):
    router.hedge_ms = 50.0


def raw_setter(router, p99):
    router.apply_knob("max_wait_ms", 2.0 * p99)


def tighten(router):
    router.admission.backpressure_at = 8


def scale(router):
    router.deactivate_replica()


def creep(batcher):
    batcher.max_wait_ms *= 2
