"""R13 negatives: the sanctioned ``_actuate``/``_apply`` path, non-tuning
attribute writes, and non-actuation calls."""
from pdnlp_tpu_torch.serve.controller import ServeController  # noqa: F401


class TinyController:
    def _actuate(self, router, knob, value, cause):
        # THE choke point: clamp/cooldown/hold + decision record live here
        router.apply_knob(knob, value)
        router.hedge_ms = value  # a direct write inside _actuate is fine

    def _apply(self, router, value):
        # _actuate's private applier: part of the sanctioned path
        if value < 0:
            router.deactivate_replica()

    def decide(self, router, p99):
        # computing a target is not actuating it
        target = min(2000.0, 2.0 * p99)
        self._actuate(router, "hedge_ms", target, {"p99_ms": p99})


def read_only(router):
    return router.knob_values()["hedge_ms"]


def unrelated_attrs(router):
    router.poll_interval = 0.5  # not a tuning knob
    router.note = "hedge_ms"
